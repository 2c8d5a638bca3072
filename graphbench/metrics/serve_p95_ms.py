"""95th percentile of the latency of every query submitted in the window,
from submission to completion; a query that failed or never came counts as
infinitely late."""

from graphbench.readers import percentile


def read(run):
    lat = [(it["t_done"] - it["t_submit"]) * 1e3 if it["ok"] else float("inf")
           for it in run.window.items]
    return percentile(lat, 95) if lat else None
