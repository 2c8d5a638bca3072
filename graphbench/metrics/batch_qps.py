"""Queries completed in the window over the window's seconds (batched)."""


def read(run):
    done = [it for it in run.window.items if it["ok"]]
    return len(done) / run.window.seconds if done else None
