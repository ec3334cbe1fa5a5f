"""Set-up: from the process's start to the window's (loading, inputs,
the warm pass, and in a new checkout the kernels' build)."""
SOURCE = "host_clock"


def read(run):
    return run.setup_s
