"""Window ms over the batched engine's steps (each batch's step count is
`run_batch`'s `iterations`)."""


def read(run):
    steps = run.window.counters.get("steps")
    return 1e3 * run.window.seconds / steps if steps else None
