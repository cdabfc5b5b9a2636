"""The port's four DSJ kernels' share of the device's busy time in the
traced window."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "queries_per_s"


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    device_s = sum(run.trace["kernel_s"].values())
    if device_s <= 0:
        return None
    return 100.0 * device_s / run.trace["busy_s"]
