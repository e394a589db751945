"""The traced window: torch.profiler over the measured requests, reduced to
device busy time, kernel and copy times, and the breakdown the result line
carries. The harness's own spans are `record_function` ranges named
`perfbench.<span>`, so an idle gap of the device is named by the innermost
span the host was in."""

from __future__ import annotations

from dataclasses import dataclass, field

SPAN_PREFIX = "perfbench."


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels_s: float = 0.0
    htod_s: float = 0.0
    dtoh_s: float = 0.0
    other_copy_s: float = 0.0
    kernel_launches: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def union_length(intervals) -> tuple:
    """(total covered length, merged intervals) of [(start, end), ...]."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def gaps(merged, lo: float, hi: float) -> list:
    "[(start, end)] of [lo, hi] not covered by the merged intervals."
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def innermost(spans, t: float) -> str:
    "The name of the shortest span holding time t, or 'harness'."
    best, length = "harness", None
    for name, s, e in spans:
        if s <= t <= e and (length is None or e - s < length):
            best, length = name, e - s
    return best


def reduce(device_events, host_spans, top: int = 10) -> TraceSummary:
    """device_events: [(name, start_us, end_us)] of the device's operations;
    host_spans: [(name, start_us, end_us)] of the harness's spans, the
    window among them."""
    window = [(s, e) for n, s, e in host_spans if n == "window"]
    if not window:
        raise ValueError("the trace holds no window span")
    lo, hi = window[0]
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events if e > lo and s < hi]
    out = TraceSummary(window_s=(hi - lo) / 1e6)
    by_name = {}
    for n, s, e in inside:
        d = (e - s) / 1e6
        by_name[n] = by_name.get(n, 0.0) + d
        if n.startswith("Memcpy HtoD"):
            out.htod_s += d
        elif n.startswith("Memcpy DtoH"):
            out.dtoh_s += d
        elif n.startswith(("Memcpy", "Memset")):
            out.other_copy_s += d
        else:
            out.kernels_s += d
            out.kernel_launches += 1
    busy, merged = union_length([(s, e) for _, s, e in inside])
    out.busy_s = busy / 1e6
    out.device_ops = [[n, d] for n, d in sorted(by_name.items(), key=lambda x: -x[1])[:top]]
    named = [(n, s, e) for n, s, e in host_spans if n != "window"]
    idle = {}
    for s, e in gaps(merged, lo, hi):
        label = innermost(named, (s + e) / 2)
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    out.idle_gaps = [[n, d] for n, d in sorted(idle.items(), key=lambda x: -x[1])[:top]]
    return out


class Profiler:
    "torch.profiler over CPU and CUDA activity, started and stopped by the harness."

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, supported_activities

        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("this torch.profiler cannot record CUDA activity")
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def summary(self) -> TraceSummary:
        from torch.autograd import DeviceType

        device, host = [], []
        for ev in self._prof.events():
            tr = ev.time_range
            if ev.name.startswith(SPAN_PREFIX):
                # a record_function range shows on the host and, as a user
                # annotation, on the device's timeline too: a span, not device work
                if ev.device_type != DeviceType.CUDA:
                    host.append((ev.name[len(SPAN_PREFIX) :], tr.start, tr.end))
            elif ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
                device.append((ev.name, tr.start, tr.end))
        return reduce(device, host)
