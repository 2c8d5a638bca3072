"""Driver-loop iterations of `core.engine.run` a search (`stats
["iterations"]`), the mean over the window's searches."""


def read(run):
    iters = [it["iters"] for it in run.window.items if "iters" in it]
    return sum(iters) / len(iters) if iters else None
