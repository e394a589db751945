"""One run of one cell: set-up, warm-up, the measured window, the traced
window, the metrics and the comparison that decides `correct`.

Everything a cell needs is found by name from `BENCHMARK.json`: the cell's
configuration file (`configs/<config>.json`, which names its entry adapter
and its reference), its traffic (`traffic/<traffic>.json`), the entry
adapter (`entries/<entry>.py`) and one reader a metric
(`metrics/<metric>.py`). Adding a cell or a metric adds files and entries.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # perfbench/
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sourmash_tpu")


class RunFailed(Exception):
    "The run cannot give a result: it prints none and exits with another code than 0."


# -- finding things by name ----------------------------------------------------


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    "The module in `path`, loaded under a name of its own."
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise RunFailed(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: str

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> list:
        "The metrics this cell reports in a run with or without the trace."
        chosen = self.per_layer if trace else self.end_to_end
        return [m for m in chosen if self.name in m.get("workloads", [self.name])]


def find_cell(root: str, workload: str) -> Cell:
    spec_path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(spec_path):
        raise RunFailed(f"no BENCHMARK.json in {root}")
    spec = load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunFailed(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic", w["traffic"] + ".json"))
    return Cell(w, config, traffic, spec["end_to_end"], spec["per_layer"], root)


# -- what a run records --------------------------------------------------------


class Spans:
    """Host time by span name, counted over the window; with the trace on,
    each span is also a `record_function` range on the profiler's timeline."""

    def __init__(self, traced: bool = False):
        self.totals: dict = {}
        self.counts: dict = {}
        self.traced = traced
        self.on = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        rf = None
        if self.traced:
            from torch.autograd.profiler import record_function

            rf = record_function("perfbench." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1
            if rf is not None:
                rf.__exit__(None, None, None)


@dataclass
class Context:
    "What an entry adapter gets: the cell, the seed, where to work, and the spans."
    cell: Cell
    seed: int
    device: str
    workdir: str
    rehearsal: bool = False
    program: str = "port"  # "control": the reference's control in the program's place
    spans: Spans = field(default_factory=Spans)
    split: dict = field(default_factory=dict)  # set-up seconds by phase

    @contextlib.contextmanager
    def phase(self, name: str):
        "Count the block's seconds into the set-up split under `name`."
        t = time.perf_counter()
        try:
            yield
        finally:
            self.split[name] = self.split.get(name, 0.0) + time.perf_counter() - t

    def load_kernels(self):
        """Build or load the program's libraries the configuration names
        (`kernel_libraries`), so that set-up's split shows their load; on
        the CPU there is none to load."""
        if self.device != "cuda":
            return
        with self.phase("kernels"):
            for name in self.cell.config.get("kernel_libraries", []):
                if name == "native":
                    from sourmash_tpu_torch import native

                    native.build()
                else:
                    from sourmash_tpu_torch.ops import _build

                    _build.load(name)

    def params(self, part: str) -> dict:
        "The configuration's or traffic's parameters, with the rehearsal's sizes in a rehearsal."
        src = self.cell.config if part == "config" else self.cell.traffic
        out = {k: v for k, v in src.items() if k != "rehearsal"}
        if self.rehearsal:
            out.update(src.get("rehearsal", {}))
        return out


@dataclass
class Run:
    "What the metric readers read."
    cell: Cell
    setup_s: float
    window_s: float
    latencies: list
    work: list
    counters: dict
    spans: Spans
    trace: object = None
    clock_hz: float = 0.0

    def quantile(self, q: float) -> float:
        "The q-quantile of the requests' latencies (Python's inclusive method)."
        if len(self.latencies) < 2:
            return self.latencies[0]
        cuts = statistics.quantiles(self.latencies, n=100, method="inclusive")
        return cuts[int(round(q * 100)) - 1]


# -- the run -------------------------------------------------------------------


def forbidden_modules() -> list:
    "Top-level module names in sys.modules that the run must not hold."
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def host_share(cpu0: float, cpu1: float, seconds: float) -> dict:
    """What the host gave a stretch of the run: this process's CPU seconds
    a second of it (about 1 where one thread does the work)."""
    return {"process_cpu_per_s": (cpu1 - cpu0) / seconds if seconds > 0 else 0.0}


def device_info(device: str) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def sync(device: str):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def measure(cell: Cell, seed: int, seconds: float, trace: bool, *, t0: float,
            device: str = "cuda", rehearsal: bool = False, program: str = "port",
            guard: bool = True, split: dict | None = None, host_start: float | None = None,
            log=print) -> dict:
    """Run one cell once and return its result line's object. Raises
    RunFailed where the run can give no result. guard=False leaves out the
    look for forbidden modules (for a caller that loaded them itself)."""
    spans = Spans(traced=trace)
    entry = load_module(os.path.join(cell.root, "perfbench", "entries",
                                     cell.config["entry"] + ".py"),
                        "perfbench_entry_" + cell.config["entry"])
    with tempfile.TemporaryDirectory(prefix="perfbench-") as workdir:
        ctx = Context(cell, seed, device, workdir, rehearsal, program, spans, dict(split or {}))
        ctx.load_kernels()
        session = entry.Session(ctx)
        with ctx.phase("warm_up"):
            session.warm()
            sync(device)
        setup_s = time.perf_counter() - t0
        log(f"perfbench: set-up {setup_s:.3f} s ({session.describe()}); split "
            f"{json.dumps({k: round(v, 3) for k, v in ctx.split.items()})}", file=sys.stderr)

        prof = None
        if trace:
            from . import trace as tracing

            prof = tracing.Profiler()
            prof.__enter__()
        spans.on = True
        latencies, work = [], []
        failed = 0
        # a session whose requests differ in size in a fixed cycle ends its
        # window on a whole cycle, so that every window holds the same mix
        cycle = max(1, int(getattr(session, "cycle", 1)))
        host0 = time.process_time()
        host = {"setup": host_share(host_start, host0, setup_s)} if host_start is not None else {}
        with spans.span("window"):
            start = time.perf_counter()
            deadline = start + seconds
            last = start
            i = 0
            while True:
                r0 = time.perf_counter()
                with spans.span("request"):
                    try:
                        done = session.request(i)
                        sync(device)
                    except Exception as exc:  # a failed request counts against the run
                        failed += 1
                        done = 0.0
                        log(f"perfbench: request {i} failed: {exc!r}", file=sys.stderr)
                last = time.perf_counter()
                latencies.append(last - r0)
                work.append(done)
                i += 1
                if last >= deadline and i % cycle == 0:
                    break
        spans.on = False
        window_s = last - start
        host["window"] = host_share(host0, time.process_time(), window_s)
        summary = None
        if prof is not None:
            prof.__exit__(None, None, None)
            summary = prof.summary()
        found = forbidden_modules() if guard else []
        if found:
            raise RunFailed(f"the run's process holds {found} after the window")
        info = device_info(device)
        log(f"perfbench: window {window_s:.3f} s, {len(latencies)} requests "
            f"({failed} failed, cycle {cycle}), work {sum(work):.6g} {session.work_unit}; "
            f"host {json.dumps(host)}", file=sys.stderr)
        counters = session.counters(len(latencies))
        log(f"perfbench: counters {json.dumps(counters)}", file=sys.stderr)
        session.close()

        from . import peaks

        run = Run(cell, setup_s, window_s, latencies, work, counters, spans, summary,
                  peaks.max_sm_clock_hz() if device == "cuda" else peaks.H100_MAX_SM_HZ)
        metrics = read_metrics(cell, run, trace)
        checks = session.check(len(latencies))
        if failed:
            checks.append(("failed_requests", failed, 0))
        correct = all(v <= lim for _, v, lim in checks)

    out = {"correct": correct, "attempted": len(latencies), "failed": failed,
           "metrics": metrics, "device": info}
    if summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    out["host"] = host
    out["setup_split"] = ctx.split
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out


def read_metrics(cell: Cell, run: Run, trace: bool) -> dict:
    "Each of the cell's metrics from its reader; a reader that finds nothing gives none."
    out = {}
    for m in cell.metrics(trace):
        reader = load_module(os.path.join(cell.root, "perfbench", "metrics", m["name"] + ".py"),
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def set_environment(root: str):
    """Caches inside the checkout at fixed paths, and no JAX through any
    library that would load it by itself."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["SOURMASH_TORCH_BUILD_DIR"] = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["SOURMASH_TORCH_VIEW_CACHE"] = "0"


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    host_start = time.process_time()
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the reference's control in the program's place (not a benchmark run)")
    args = ap.parse_args(argv)
    try:
        cell = find_cell(ROOT, args.workload)
        set_environment(ROOT)
        import torch

        t_import = time.perf_counter()
        chips = int(cell.workload.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunFailed(f"the cell needs {chips} CUDA device(s); "
                            f"torch sees {torch.cuda.device_count()}")
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        split = {"import": t_import - t0, "cuda_init": time.perf_counter() - t_import}
        out = measure(cell, args.seed, args.seconds, bool(args.trace), t0=t0,
                      program="control" if args.control else "port", split=split,
                      host_start=host_start)
    except RunFailed as exc:
        print(f"perfbench: no result: {exc}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"perfbench check: {name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0
