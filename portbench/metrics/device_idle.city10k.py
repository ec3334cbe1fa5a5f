"""Share of the traced window with no kernel or copy on the device."""
from portbench.readers import device_idle

SOURCE = "device_trace"


def read(run):
    return device_idle(run)
