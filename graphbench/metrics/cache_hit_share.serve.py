"""% of the server's result-cache lookups that hit (`GraphServer.stats()`)."""


def read(run):
    cache = run.window.counters.get("cache")
    if not cache:
        return None
    looked = cache["hits"] + cache["misses"]
    return 100.0 * cache["hits"] / looked if looked else None
