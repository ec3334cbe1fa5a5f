"""pcg_solve's share of its roofline: the bytes bound of each launch
(``roofline.pcg_solve_bytes``) over the trace's time of the PCG kernel."""
from portbench import roofline

SOURCE = "device_trace"


def _is_pcg(name: str) -> bool:
    return "pcg(" in name and "normal_system" not in name


def read(run):
    if run.trace is None:
        return None
    seconds, count = run.trace.kernel_time(_is_pcg)
    if not count:
        return None
    return roofline.share(roofline.bound_s(run.extra["pcg_bytes"]) * count,
                          seconds)
