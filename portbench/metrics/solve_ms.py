"""The window's ms over the whole solve_graph calls completed in it."""
SOURCE = "host_clock"


def read(run):
    n = run.counts.get("solves")
    return 1e3 * run.window_s / n if n else None
