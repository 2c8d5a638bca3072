"""Launches of the port's hand-written kernels a search
(`kernels.ops.launch_counts()` over the window)."""


def read(run):
    launches = run.window.counters.get("launches")
    if not launches or not run.window.items:
        return None
    return sum(launches.values()) / len(run.window.items)
