"""The port's four DSJ kernels' share of their roofline: the least time
the window's launches could take (each launch's bytes, from its shapes,
at the card's HBM peak: ``roofline.py``) over the device time the trace
gives everything those launches' wrappers ran."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "queries_per_s"


def read(run):
    if run.trace is None:
        return None
    device_s = sum(run.trace["kernel_s"].values())
    if device_s <= 0 or run.launch_bytes_bound_s <= 0:
        return None
    return 100.0 * run.launch_bytes_bound_s / device_s
