"""The port's programs as a traffic mix names them, and the seeded picks
the drivers share."""

from __future__ import annotations

import random


def program(traffic: dict, name: str):
    """The port's ACC program `name` with the mix's parameters (a placeholder
    source; the drivers pass each query's source)."""
    from repro_torch.core import algorithms as alg

    return alg.ALL[name](0, **traffic.get("params", {}).get(name, {}))


def result_field(prog) -> str:
    return prog.param("result", prog.primary)


def pick(seed: int, salt: int, items: list, k: int) -> list:
    """`k` of `items` (all, if fewer), drawn from the seed."""
    rng = random.Random(seed * 1_000_003 + salt)
    return rng.sample(items, min(k, len(items)))
