"""Combiner backend: ACC-C401..C403 — property-probe every registered
Combiner for the algebra its engine contracts assume (DESIGN.md §16).

Port of `repro.analysis.combiner_check`, on the caller's device. Everything
downstream leans on the monoid laws: the keyed segment combine is only
order-free if ⊕ is commutative+associative with a true identity (the
sentinel scratch slot IS the identity); the §9 edge-shard merge folds
partial combines across shards assuming the same; the serving cache's
bit-exactness and the batched-vs-solo agreement assume the pinned reduction
tree commutes with batching. `vote` dedup-free re-expansion additionally
needs idempotency.

The probes are bit-exact, not approximate: sample values are dyadic
rationals (k/8) well inside float32's 24-bit mantissa, so even `sum` is
associative on them EXACTLY — a law failure is a real algebra bug, never
float noise. On the card `segment` runs the `segment_reduce` kernel: at
D = 1 for the keyed combine and for `segment_stacked` (whose rows fold into
the segment-id space), and at D = q for the batched engine's layout (an
(E, q) plane over shared ids, each column against its own (E,) call).
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional

import numpy as np
import torch

from .findings import Finding

#: dyadic-rational float32 samples: closed under + (within range), so every
#: monoid law below holds bit-exactly for min/max/sum
_SAMPLES = np.asarray([-2.5, -0.375, 0.0, 0.125, 1.0, 3.75], np.float32)
#: the C403 draws: edges, segments, batch rows (the reference's)
_E, _N, _Q = 23, 5, 3


def _path(comb) -> str:
    return f"combiner:{comb.name}/{comb.kind}"


def _draws() -> dict:
    """The C403 inputs, drawn in the reference's order from
    `default_rng(7)`, as numpy arrays."""
    rng = np.random.default_rng(7)
    vals = rng.choice(_SAMPLES, size=(_E,))
    ids = rng.integers(0, _N, size=(_E,)).astype(np.int32)
    vq = rng.choice(_SAMPLES, size=(_Q, _E))
    iq = rng.integers(0, _N, size=(_Q, _E)).astype(np.int32)
    stack = rng.choice(_SAMPLES, size=(6, _N, _Q))
    return {"vals": vals, "ids": ids, "vq": vq, "iq": iq, "stack": stack}


def probe_values(comb, device) -> dict:
    """The C403 reductions of `comb` on `device`: name -> tensor. `segment`
    and `fold` (the sequential lane-order pair() fold) must agree, and so
    must `stacked`/`rows`, `columns`/`rows_shared` and `tree`/`tree_cols`.
    Raises what the combiner raises."""
    dev = torch.device(device)
    draws = _draws()
    d = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in draws.items()}
    n = _N
    out = {"segment": comb.segment(d["vals"], d["ids"], n)}
    ident = comb.identity(torch.float32, dev)
    fold = [ident] * n
    ids = draws["ids"]
    for i in range(_E):                     # sequential left fold, lane order
        fold[ids[i]] = comb.pair(fold[ids[i]], d["vals"][i])
    out["fold"] = torch.stack(fold)
    # batched stack: every row of segment_stacked must equal its own
    # unbatched segment() bit-for-bit (the serving engine's layout
    # independence)
    out["stacked"] = comb.segment_stacked(d["vq"], d["iq"], n)
    out["rows"] = torch.stack([comb.segment(d["vq"][r], d["iq"][r], n)
                               for r in range(_Q)])
    # the batched engine's own layout: one (E, q) plane over shared ids
    out["columns"] = comb.segment(d["vq"].T.contiguous(), d["ids"], n).T
    out["rows_shared"] = torch.stack([comb.segment(d["vq"][r], d["ids"], n)
                                      for r in range(_Q)])
    # the pinned halving tree must commute with a trailing batch axis
    out["tree"] = comb.reduce_axis_tree(d["stack"], 0)
    out["tree_cols"] = torch.stack(
        [comb.reduce_axis_tree(d["stack"][:, :, c], 0) for c in range(_Q)], dim=-1)
    return out


def check_combiner(comb, device="cuda") -> list[Finding]:
    """C401..C403 for one combiner, its probes on `device`."""
    dev = torch.device(device)
    path = _path(comb)
    out: list[Finding] = []

    def flag(rule: str, msg: str) -> None:
        out.append(Finding(rule, path, 0, msg))

    try:
        iv = comb.identity(torch.float32, dev)
    except Exception as e:                              # noqa: BLE001
        flag("ACC-C401", f"identity() raised {type(e).__name__}: {e}")
        return out

    xs = [torch.tensor(float(v), dtype=torch.float32, device=dev)
          for v in _SAMPLES]
    fs = [float(v) for v in _SAMPLES]

    # -- C401: monoid laws ---------------------------------------------------
    for x, fx in zip(xs, fs):
        if not (torch.equal(comb.pair(iv, x), x) and torch.equal(comb.pair(x, iv), x)):
            flag("ACC-C401",
                 f"identity law fails: pair(identity, {fx}) != {fx} — the "
                 "sentinel scratch slot would leak into segment combines")
            break
    for (a, fa), (b, fb), (c, fc) in itertools.product(zip(xs, fs), repeat=3):
        if not torch.equal(comb.pair(comb.pair(a, b), c),
                   comb.pair(a, comb.pair(b, c))):
            flag("ACC-C401",
                 f"associativity fails on ({fa}, {fb}, {fc}) — segment/tree "
                 "reductions are order-dependent")
            break
    for (a, fa), (b, fb) in itertools.product(zip(xs, fs), repeat=2):
        if not torch.equal(comb.pair(a, b), comb.pair(b, a)):
            flag("ACC-C401",
                 f"commutativity fails on ({fa}, {fb}) — edge order would "
                 "leak into combines")
            break

    # -- C402: idempotency declaration ---------------------------------------
    idem_holds = all(torch.equal(comb.pair(x, x), x) for x in xs)
    if comb.idempotent and not idem_holds:
        flag("ACC-C402",
             "declared idempotent but pair(x, x) != x — frontier "
             "duplicates would double-apply")
    if comb.kind == "vote" and not idem_holds:
        flag("ACC-C402",
             "'vote' kind on a non-idempotent monoid — vote semantics skip "
             "dedup before re-expansion (paper §3.2)")

    # -- C403: segment vs pairwise fold vs pinned tree -----------------------
    try:
        p = probe_values(comb, dev)
    except Exception as ex:                             # noqa: BLE001
        flag("ACC-C403", f"reduction probe raised {type(ex).__name__}: {ex}")
        return out
    if not torch.equal(p["segment"], p["fold"]):
        flag("ACC-C403",
             "segment() disagrees with the sequential lane-order pair() "
             "fold on dyadic samples — the keyed combine is not the "
             "monoid it claims")
    if not torch.equal(p["stacked"], p["rows"]):
        flag("ACC-C403",
             "segment_stacked() row differs bitwise from the unbatched "
             "segment() — batching changed the combine")
    if not torch.equal(p["columns"], p["rows_shared"]):
        flag("ACC-C403",
             "a column of segment() over an (E, q) plane differs bitwise "
             "from the (E,) call on it — the batched engine's layout "
             "changed the combine")
    if not torch.equal(p["tree"], p["tree_cols"]):
        flag("ACC-C403",
             "reduce_axis_tree() result depends on the trailing batch "
             "axis — the pinned association tree is not layout-"
             "independent")
    return out


def registered_combiners(programs: Optional[dict] = None) -> list:
    """The module-level combiners plus every one a catalog program uses,
    deduped by (name, kind, type)."""
    from repro_torch.core import acc

    if programs is None:
        from repro_torch.launch.catalog import make_catalog
        programs = make_catalog()
    combs = [acc.MIN_VOTE, acc.MIN_AGG, acc.SUM_AGG, acc.MAX_VOTE]
    combs += [p.combiner for p in programs.values()]
    seen, out = set(), []
    for c in combs:
        key = (type(c).__name__, c.name, c.kind)
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def check_registered(programs: Optional[dict] = None,
                     extra: Iterable = (), device="cuda") -> tuple:
    """ACC-C401..C403 over every registered combiner (+ `extra` for
    fixtures) on `device`. Returns (findings, n)."""
    combs = registered_combiners(programs) + list(extra)
    findings: list[Finding] = []
    for c in combs:
        findings.extend(check_combiner(c, device))
    return findings, len(combs)
