"""Served queries completed inside the window, cache hits included, over
the window's seconds."""


def read(run):
    close = run.window.counters["t0"] + run.window.seconds
    return sum(it["ok"] and it["t_done"] <= close for it in run.window.items) / run.window.seconds
