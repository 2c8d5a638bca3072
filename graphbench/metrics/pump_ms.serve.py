"""Host ms of one `GraphServer.pump()` round, the mean over the window's
rounds (the benchmark's span around each call)."""


def read(run):
    rounds = run.window.spans.get("pump", [])
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
