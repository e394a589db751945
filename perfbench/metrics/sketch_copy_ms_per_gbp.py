"""sketch_copy_ms_per_gbp: device ms of host-to-device and device-to-host
copies (torch.profiler's Memcpy HtoD and DtoH) in the traced window, a Gbp
sketched."""


def read(run):
    gbp = sum(run.work) / 1e3
    if run.trace is None or not gbp:
        return None
    return (run.trace.htod_s + run.trace.dtoh_s) * 1e3 / gbp
