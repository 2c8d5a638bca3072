"""Graph algorithms expressed in the ACC model (paper Sec. 3.3 + Sec. 6).

Port of `repro.core.algorithms`: the same ten programs with the same
`primary`, `modes`, `fixed_iters`, `params` and `with_tol`. Each program also
names its Compute op in `kernel_compute` for the CUDA `ell_combine` pull.

Inits take the live degrees as a tensor and build metadata on its device.
`belief_propagation`'s pseudo-priors and `mis`'s priorities use `torch.sin`,
which differs from XLA's in the last bit at large arguments; a bit-exact
comparison with the reference starts both from the same metadata (`priors=`
for bp, an injected init for mis).
"""

from __future__ import annotations

import torch

from repro_torch.core.acc import (
    ACCProgram,
    MAX_VOTE,
    MIN_AGG,
    MIN_VOTE,
    SUM_AGG,
    Meta,
)
from repro_torch.core.frontier import compact_mask
from repro_torch.kernels.ell_spmv import BIG


def _set_source(t: torch.Tensor, source: int, value: float) -> torch.Tensor:
    """`t[source] = value` as the reference's `.at[source].set(value)`: an id
    in [-(n+1), n] is written (negatives wrap, -1 is the scratch row), any
    other is dropped. The raw id never indexes the tensor: on the card an
    out-of-range index is a device-side assert."""
    size = t.shape[0]
    if -size <= int(source) < size:
        t[int(source)] = value
    return t


def _one_hot_dist(n: int, source: int, dev) -> torch.Tensor:
    return _set_source(torch.full((n + 1,), BIG, dtype=torch.float32, device=dev),
                       source, 0.0)


def _degf(deg: torch.Tensor) -> torch.Tensor:
    """(n+1,) float degrees clamped at 1, scratch slot 1."""
    safe = torch.clamp(deg, min=1).to(torch.float32)
    return torch.cat([safe, torch.ones((1,), dtype=torch.float32, device=deg.device)])


# ---------------------------------------------------------------------------
# BFS / SSSP / WCC
# ---------------------------------------------------------------------------


def bfs(src: int) -> ACCProgram:
    def init(n, deg, source=src):
        dev = deg.device
        return ({"dist": _one_hot_dist(n, source, dev)},
                torch.tensor([source], dtype=torch.int32, device=dev))

    def compute(sender: Meta, w, receiver: Meta):
        del receiver
        return torch.where(sender["dist"] < BIG, sender["dist"] + 1.0, BIG)

    def active(new: Meta, old: Meta, it):
        del it
        return new["dist"] < old["dist"]

    return ACCProgram(
        name="bfs", combiner=MIN_VOTE, init=init, compute=compute,
        active=active, primary="dist", params=(("result", "dist"),),
        kernel_compute="hop",
    )


def sssp(src: int) -> ACCProgram:
    def init(n, deg, source=src):
        dev = deg.device
        return ({"dist": _one_hot_dist(n, source, dev)},
                torch.tensor([source], dtype=torch.int32, device=dev))

    def compute(sender: Meta, w, receiver: Meta):
        del receiver
        return torch.where(sender["dist"] < BIG, sender["dist"] + w, BIG)

    def active(new: Meta, old: Meta, it):
        del it
        return new["dist"] < old["dist"]

    return ACCProgram(
        name="sssp", combiner=MIN_AGG, init=init, compute=compute,
        active=active, primary="dist", params=(("result", "dist"),),
        kernel_compute="add_w",
    )


def wcc() -> ACCProgram:
    def init(n, deg):
        dev = deg.device
        comp = torch.arange(n + 1, dtype=torch.float32, device=dev)
        comp[n] = BIG
        return {"comp": comp}, torch.arange(n, dtype=torch.int32, device=dev)

    def compute(sender: Meta, w, receiver: Meta):
        del w, receiver
        return sender["comp"]

    def active(new: Meta, old: Meta, it):
        del it
        return new["comp"] < old["comp"]

    return ACCProgram(
        name="wcc", combiner=MIN_VOTE, init=init, compute=compute,
        active=active, primary="comp", params=(("result", "comp"),),
        kernel_compute="copy",
    )


# ---------------------------------------------------------------------------
# PageRank family
# ---------------------------------------------------------------------------


def pagerank(damping: float = 0.85, tol: float = 1e-4, max_iters: int = 64) -> ACCProgram:
    def init(n, deg):
        dev = deg.device
        rank = torch.full((n + 1,), 1.0 / n, dtype=torch.float32, device=dev)
        safe = torch.clamp(deg, min=1).to(torch.float32)
        contrib = torch.cat([rank[:-1] / safe, torch.zeros((1,), dtype=torch.float32, device=dev)])
        rank[n] = 0.0
        return ({"contrib": contrib, "rank": rank, "deg": _degf(deg)},
                torch.arange(n, dtype=torch.int32, device=dev))

    def compute(sender: Meta, w, receiver: Meta):
        del w, receiver
        return sender["contrib"]

    def apply(m: Meta, seg, it):
        del it
        n = m["rank"].shape[0] - 1
        new_rank = (1.0 - damping) / n + damping * seg
        return {"rank": new_rank, "contrib": new_rank / m["deg"], "deg": m["deg"]}

    def active(new: Meta, old: Meta, it):
        del it
        return torch.abs(new["rank"] - old["rank"]) > tol

    return ACCProgram(
        name="pagerank", combiner=SUM_AGG, init=init, compute=compute,
        active=active, apply=apply, primary="contrib", modes="pull",
        fixed_iters=max_iters, params=(("result", "rank"),),
        kernel_compute="copy",
    )


def ppr(src: int = 0, damping: float = 0.85, tol: float = 1e-5,
        max_iters: int = 64) -> ACCProgram:
    """Personalized PageRank by pull-mode power iteration; the teleport
    vector is the one-hot preference carried in metadata (`pref`)."""

    def init(n, deg, source=src):
        dev = deg.device
        pref = _set_source(torch.zeros((n + 1,), dtype=torch.float32, device=dev),
                           source, 1.0)
        degf = _degf(deg)
        return ({"contrib": pref / degf, "rank": pref, "pref": pref, "deg": degf},
                torch.arange(n, dtype=torch.int32, device=dev))

    def compute(sender: Meta, w, receiver: Meta):
        del w, receiver
        return sender["contrib"]

    def apply(m: Meta, seg, it):
        del it
        new_rank = (1.0 - damping) * m["pref"] + damping * seg
        return {"rank": new_rank, "contrib": new_rank / m["deg"],
                "pref": m["pref"], "deg": m["deg"]}

    def active(new: Meta, old: Meta, it):
        del it
        return torch.abs(new["rank"] - old["rank"]) > tol

    return ACCProgram(
        name="ppr", combiner=SUM_AGG, init=init, compute=compute,
        active=active, apply=apply, primary="contrib", modes="pull",
        fixed_iters=max_iters, params=(("result", "rank"),),
        kernel_compute="copy",
    )


def ppr_delta(src: int = 0, damping: float = 0.85, tol: float = 1e-5,
              max_iters: int = 256) -> ACCProgram:
    """Residual-push personalized PageRank (ACL / Maiter style): (rank,
    resid) split, Active = |resid| > tol*deg, Compute pushes the `send`
    plane damping*resid/deg, Combine = SUM."""

    def _ta(m: Meta):
        return tol * m["deg"]

    def init(n, deg, source=src):
        dev = deg.device
        pref = _set_source(torch.zeros((n + 1,), dtype=torch.float32, device=dev),
                           source, 1.0)
        rank = torch.zeros((n + 1,), dtype=torch.float32, device=dev)
        degf = _degf(deg)
        resid = pref
        send = torch.where(torch.abs(resid) > tol * degf, damping * resid / degf, 0.0)
        return ({"rank": rank, "resid": resid, "send": send, "deg": degf},
                torch.tensor([source], dtype=torch.int32, device=dev))

    def compute(sender: Meta, w, receiver: Meta):
        del w, receiver
        return sender["send"]

    def apply(m: Meta, seg, it):
        del it
        ta = _ta(m)
        act = torch.abs(m["resid"]) > ta
        rank = m["rank"] + torch.where(act, (1.0 - damping) * m["resid"], 0.0)
        resid = torch.where(act, 0.0, m["resid"]) + seg
        send = torch.where(torch.abs(resid) > ta, damping * resid / m["deg"], 0.0)
        return {"rank": rank, "resid": resid, "send": send, "deg": m["deg"]}

    def active(new: Meta, old: Meta, it):
        del old, it
        return torch.abs(new["resid"]) > _ta(new)

    return ACCProgram(
        name="ppr_delta", combiner=SUM_AGG, init=init, compute=compute,
        active=active, apply=apply, primary="send", fixed_iters=max_iters,
        params=(("kind", "residual"), ("damping", float(damping)),
                ("tol", float(tol)), ("estimate", "rank"),
                ("residual", "resid"), ("threshold", "degree"),
                ("settle", 1.0 - float(damping)), ("result", "rank")),
        with_tol=lambda t: ppr_delta(src, damping=damping, tol=t,
                                     max_iters=max_iters),
        kernel_compute="copy",
    )


def pagerank_delta(damping: float = 0.85, tol: float = 1e-5, max_iters: int = 128) -> ACCProgram:
    """Delta/residual PageRank: source-free residual program with an
    absolute threshold tol/n and settle 1.0."""

    def _tol_abs(arr):
        return tol / (arr.shape[0] - 1)

    def init(n, deg):
        dev = deg.device
        rank = torch.zeros((n + 1,), dtype=torch.float32, device=dev)
        resid = torch.full((n + 1,), 1.0 / n, dtype=torch.float32, device=dev)
        resid[n] = 0.0
        degf = _degf(deg)
        send = torch.where(torch.abs(resid) > _tol_abs(resid), damping * resid / degf, 0.0)
        return ({"rank": rank, "resid": resid, "send": send, "deg": degf},
                torch.arange(n, dtype=torch.int32, device=dev))

    def compute(sender: Meta, w, receiver: Meta):
        del w, receiver
        return sender["send"]

    def apply(m: Meta, seg, it):
        del it
        ta = _tol_abs(m["resid"])
        act = torch.abs(m["resid"]) > ta
        rank = m["rank"] + torch.where(act, m["resid"], 0.0)
        resid = torch.where(act, 0.0, m["resid"]) + seg
        send = torch.where(torch.abs(resid) > ta, damping * resid / m["deg"], 0.0)
        return {"rank": rank, "resid": resid, "send": send, "deg": m["deg"]}

    def active(new: Meta, old: Meta, it):
        del it
        return torch.abs(new["resid"]) > _tol_abs(new["resid"])

    return ACCProgram(
        name="pagerank_delta", combiner=SUM_AGG, init=init, compute=compute,
        active=active, apply=apply, primary="send", fixed_iters=max_iters,
        params=(("kind", "residual"), ("damping", float(damping)),
                ("tol", float(tol)), ("estimate", "rank"),
                ("residual", "resid"), ("threshold", "absolute"),
                ("settle", 1.0), ("result", "rank")),
        with_tol=lambda t: pagerank_delta(damping=damping, tol=t,
                                          max_iters=max_iters),
        kernel_compute="copy",
    )


# ---------------------------------------------------------------------------
# k-Core
# ---------------------------------------------------------------------------


def kcore(k: int = 16, max_iters: int = 512) -> ACCProgram:
    """Iteratively delete vertices with degree < k; the frontier is the set
    deleted this iteration, each pushing a unit decrement to its neighbours."""

    def init(n, deg, kk=k):
        dev = deg.device
        degf = torch.cat([deg.to(torch.float32), torch.zeros((1,), dtype=torch.float32, device=dev)])
        dead_now = degf < kk
        dead_now[-1] = False
        alive = ~dead_now
        degf = torch.where(dead_now, 0.0, degf)
        ids = compact_mask(dead_now, n, fill=n)[0]
        return ({"dead_now": dead_now.to(torch.float32),
                 "alive": alive.to(torch.float32), "deg": degf}, ids)

    def compute(sender: Meta, w, receiver: Meta):
        del w, receiver
        return sender["dead_now"]

    def apply(m: Meta, seg, it):
        del it
        alive = m["alive"] > 0
        deg = torch.where(alive, torch.clamp(m["deg"] - seg, min=0.0), 0.0)
        dead_now = alive & (deg < k) & (seg > 0)
        return {"dead_now": dead_now.to(torch.float32),
                "alive": (alive & ~dead_now).to(torch.float32),
                "deg": torch.where(dead_now, 0.0, deg)}

    def active(new: Meta, old: Meta, it):
        del it, old
        return new["dead_now"] > 0

    return ACCProgram(
        name="kcore", combiner=SUM_AGG, init=init, compute=compute,
        active=active, apply=apply, primary="dead_now", fixed_iters=max_iters,
        params=(("incremental", "cascade"), ("k", float(k)),
                ("result", "alive"), ("resume_fields", ("alive",))),
        kernel_compute="copy",
    )


# ---------------------------------------------------------------------------
# Belief propagation
# ---------------------------------------------------------------------------


def belief_propagation(n_iters: int = 16, damping: float = 0.5) -> ACCProgram:
    """All-active aggregation workload with a fixed iteration budget."""

    def init(n, deg, priors=None):
        dev = deg.device
        if priors is None:
            x = torch.arange(n, dtype=torch.float32, device=dev)
            priors = 0.5 + 0.4 * torch.sin(x * 12.9898)
        priors = torch.as_tensor(priors, dtype=torch.float32).to(dev)
        b = torch.cat([priors, torch.zeros((1,), dtype=torch.float32, device=dev)])
        return {"belief": b, "prior": b}, torch.arange(n, dtype=torch.int32, device=dev)

    def compute(sender: Meta, w, receiver: Meta):
        del receiver
        return sender["belief"] * w

    def apply(m: Meta, seg, it):
        del it
        new_b = (1 - damping) * m["prior"] + damping * torch.tanh(seg * 0.01)
        return {"belief": new_b, "prior": m["prior"]}

    def active(new: Meta, old: Meta, it):
        return (it + 1 < n_iters).expand(new["belief"].shape)

    return ACCProgram(
        name="bp", combiner=SUM_AGG, init=init, compute=compute,
        active=active, apply=apply, primary="belief", modes="pull",
        fixed_iters=n_iters, params=(("result", "belief"),),
        kernel_compute="mul_w",
    )


# ---------------------------------------------------------------------------
# Maximal independent set (Luby)
# ---------------------------------------------------------------------------


def mis(seed: int = 0, max_iters: int = 128) -> ACCProgram:
    """Luby's algorithm in ACC; state: 0 undecided, 1 in-set, 2 excluded."""

    def init(n, deg, s=seed):
        dev = deg.device
        x = torch.arange(n, dtype=torch.float32, device=dev)
        pri = 0.5 + 0.49 * torch.sin((x + 1.23 * s) * 12.9898) + x / (1e3 * n)
        pri = torch.cat([pri, torch.full((1,), -BIG, dtype=torch.float32, device=dev)])
        state = torch.zeros((n + 1,), dtype=torch.float32, device=dev)
        return ({"sig": pri, "pri": pri, "state": state},
                torch.arange(n, dtype=torch.int32, device=dev))

    def compute(sender: Meta, w, receiver: Meta):
        del w, receiver
        return sender["sig"]

    def apply(m: Meta, seg, it):
        del it
        undecided = m["state"] == 0
        nbr_max = seg
        excluded = undecided & (nbr_max >= BIG / 2)
        winner = undecided & ~excluded & (m["pri"] > nbr_max)
        state = torch.where(winner, 1.0, torch.where(excluded, 2.0, m["state"]))
        sig = torch.where(state == 1.0, BIG, torch.where(state == 2.0, -BIG, m["pri"]))
        return {"sig": sig, "pri": m["pri"], "state": state}

    def active(new: Meta, old: Meta, it):
        del it
        return (new["state"] == 0) | (new["state"] != old["state"])

    return ACCProgram(
        name="mis", combiner=MAX_VOTE, init=init,
        compute=compute, active=active, apply=apply, primary="sig",
        modes="pull", fixed_iters=max_iters,
        params=(("incremental", "reelect"), ("result", "state"),
                ("resume_fields", ("sig", "pri", "state"))),
        kernel_compute="copy",
    )


ALL = {
    "bfs": bfs,
    "sssp": sssp,
    "wcc": wcc,
    "pagerank": pagerank,
    "ppr": ppr,
    "ppr_delta": ppr_delta,
    "pagerank_delta": pagerank_delta,
    "kcore": kcore,
    "bp": belief_propagation,
    "mis": mis,
}
