"""The registered serving catalog of the launch drivers (port of
`repro.launch.catalog`).

One place defines which ACC programs `serve_graph` exposes, so `--algos` validates against the REGISTERED set at
argparse time (listing the valid names in the error) instead of failing
late with a KeyError, and every driver serves the same breadth: the
traversal trio plus the whole catalog — wcc, kcore, mis, pagerank,
pagerank_delta (DESIGN.md §15).

`belief_propagation` stays out: its Active is an iteration-counter
predicate (always-on until the budget), which the serving engine's
frontier refilter does not model — it runs through the solo engine only.
"""

from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.core import algorithms as alg
from repro_torch.core.acc import ACCProgram


def make_catalog(kcore_k: int = 4) -> Dict[str, ACCProgram]:
    """name -> ACCProgram for every servable catalog algorithm.

    Source-parameterized programs get a placeholder source (admission
    re-inits per query); source-free programs ignore submitted sources
    entirely (`batch_engine._accepts_source`). `kcore_k` stays small by
    default so modest smoke graphs keep a non-empty core.
    """
    return {
        "bfs": alg.bfs(0),
        "sssp": alg.sssp(0),
        "wcc": alg.wcc(),
        "ppr": alg.ppr(0),
        "ppr_delta": alg.ppr_delta(0),
        "pagerank": alg.pagerank(),
        "pagerank_delta": alg.pagerank_delta(),
        "kcore": alg.kcore(k=kcore_k),
        "mis": alg.mis(),
    }


def result_fields(programs: Dict[str, ACCProgram]) -> Dict[str, str]:
    """Served metadata field per algo, from each program's declared
    'result' param (fallback: primary) — what the serving pools default to
    on their own; exported for drivers that need it host-side (verify)."""
    return {name: p.param("result", p.primary)
            for name, p in programs.items()}


def algos_argtype(catalog: Dict[str, ACCProgram]):
    """argparse `type=` for `--algos`: parse a comma list and validate
    against the registered catalog AT PARSE TIME, naming the valid set in
    the error (argparse also runs the type converter over a string
    default, so defaults are validated too)."""

    def parse(value: str):
        names = [a.strip() for a in value.split(",") if a.strip()]
        unknown = [a for a in names if a not in catalog]
        if unknown or not names:
            raise argparse.ArgumentTypeError(
                f"unknown algorithms {unknown or [value]}; "
                f"valid: {', '.join(sorted(catalog))}")
        return names

    return parse
