#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run (RMAT scale 22)
    python3 chip_smoke.py --quick         # build + kernel sweeps only

Phases (any failure exits non-zero; nothing is caught):
  1. card      — nvidia-smi name and power limit, torch/CUDA versions;
  2. build     — nvcc builds every kernel of the main path (csrc/*.cu);
  3. kernels   — each CUDA kernel against its plain PyTorch version on the
                 card over shape sweeps (bit-equal for ell_combine,
                 frontier_pack and min/max segment_reduce; sum within rtol
                 1e-5 and identical from run to run);
  4. main path — RMAT scale 22, edge factor 16 (Graph500 a/b/c 0.57/0.19/
                 0.19, seed 1, undirected): each kernel timed at the main
                 path's shapes, then bfs, sssp, wcc, pagerank and kcore(16)
                 through `engine.run` with the kernel pull, counted; each is
                 bit-equal to the torch pull (metadata, traces, iterations);
                 bfs and sssp equal scipy's distances;
  5. diameter  — grid2d(1024): bfs and sssp under fusion none/all/pushpull
                 give equal results, equal to scipy's;
  6. report    — the `kernels` JSON line, the card line, then the last line
                 {"ok": true, "device": {...}}.

It exits non-zero, printing no result, where torch.cuda.is_available() is
false or the package is missing beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean time of `fn` on the card: CUDA events around `iters` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries that differ (equal infinities count 0)."""
    diff = torch.where(a == b, 0.0, (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def sweep_ell(dev, rng, ell) -> float:
    shapes = [(8, 4, 50), (64, 16, 200), (128, 32, 1000), (24, 256, 300),
              (13, 4, 50), (37, 32, 100), (29, 256, 700), (100, 1, 60),
              (9, 3, 40), (17, 64, 90), (11, 128, 90), (5, 8, 30), (1, 2, 10),
              (3001, 256, 5000)]
    worst = 0.0
    for r, w, n in shapes:
        nbr = torch.from_numpy(rng.integers(0, n + 1, size=(r, w)).astype(np.int32)).to(dev)
        wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(dev)
        v = rng.random(n + 1).astype(np.float32)
        v[rng.random(n + 1) < 0.2] = ell.BIG
        v[-1] = 0.0
        vals = torch.from_numpy(v).to(dev)
        for op in ell.COMPUTE_OPS:
            for comb in ell.COMBINE_OPS:
                a = ell.ell_combine_cuda(nbr, wgt, vals, op, comb)
                b = ell.ell_combine_plain(nbr, wgt, vals, op, comb)
                torch.cuda.synchronize()
                if not bit_equal(a, b):
                    raise AssertionError(f"ell_combine {op}/{comb} R={r} W={w} n={n} differs")
                worst = max(worst, abs_err(a, b))
    return worst


def sweep_pack(dev, rng, fp) -> float:
    cases = [(1024, 0.1, None), (4096, 0.5, None), (2048, 0.95, None),
             (512, 0.0, None), (1000, 0.3, None), (3001, 0.95, None),
             (3001, 0.0, None), (5000, 0.5, 100), (1, 1.0, 1), (4096, 0.5, 0),
             (1 << 20, 0.5, None), (1 << 20, 0.01, 1000)]
    for n, dens, cap in cases:
        cap = n if cap is None else cap
        mask = torch.from_numpy(rng.random(n) < dens).to(dev)
        a = fp.frontier_pack_cuda(mask, cap)
        b = fp.frontier_pack_plain(mask, cap)
        torch.cuda.synchronize()
        for x, y, what in zip(a, b, ("ids", "count", "overflow")):
            if not bit_equal(x, y):
                raise AssertionError(f"frontier_pack n={n} density={dens} cap={cap}: {what} differs")
        exp = np.nonzero(mask.cpu().numpy())[0][:cap]
        if not np.array_equal(a[0].cpu().numpy()[: len(exp)], exp):
            raise AssertionError(f"frontier_pack n={n}: ids are not the set lanes")
    return 0.0


def sweep_segment(dev, rng, sr) -> float:
    cases = [(256, 4, 16, 0), (2048, 16, 64, 0), (512, 8, 10, 0),
             (1000, 1, 50, 0), (20000, 1, 5, 0), (50, 1, 100, 0),
             (3000, 1, 40, 3), (9000, 2, 3, 0), (0, 1, 7, 0)]
    worst = 0.0
    for e, d, s, oob in cases:
        v = rng.random((e, d)).astype(np.float32)
        ids = np.sort(rng.integers(-oob, s + oob, size=e)).astype(np.int32)
        vals = torch.from_numpy(v[:, 0] if d == 1 else v).to(dev).contiguous()
        sid = torch.from_numpy(ids).to(dev)
        for comb in ("min", "max", "sum"):
            for fill in (None, float("inf") if comb == "min" else float("-inf")):
                a = sr.segment_reduce_cuda(vals, sid, s, comb, fill)
                b = sr.segment_reduce_plain(vals, sid, s, comb, fill)
                torch.cuda.synchronize()
                if comb == "sum":
                    again = sr.segment_reduce_cuda(vals, sid, s, comb, fill)
                    if not bit_equal(a, again):
                        raise AssertionError(f"segment_reduce sum E={e} not deterministic")
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
                    worst = max(worst, abs_err(a, b))
                elif not bit_equal(a, b):
                    raise AssertionError(f"segment_reduce {comb} E={e} D={d} S={s} differs")
    return worst


# ---------------------------------------------------------------------------
# phase 4/5 helpers
# ---------------------------------------------------------------------------


def scipy_dist(g, unweighted: bool) -> np.ndarray:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    n = g.n_nodes
    a = csr_matrix((g.out.weights.cpu().numpy().astype(np.float64),
                    g.out.col_idx.cpu().numpy(), g.out.row_ptr.cpu().numpy()),
                   shape=(n, n))
    return dijkstra(a, directed=True, indices=0, unweighted=unweighted)


def check_dist(name: str, dist: torch.Tensor, ref: np.ndarray, big: float) -> None:
    got = dist[:-1].cpu().numpy().astype(np.float64)
    got[got >= big] = np.inf
    if not np.array_equal(got, ref):
        bad = int(np.sum(got != ref))
        raise AssertionError(f"{name}: {bad} distances differ from scipy")


def same_run(name, ma, sa, mb, sb) -> None:
    for k in ma:
        if not bit_equal(ma[k], mb[k]):
            raise AssertionError(f"{name}: field {k!r} differs between pulls/modes")
    for k in ("iterations", "push_iters", "pull_iters", "switches",
              "mode_trace", "fe_trace", "final_count"):
        if not torch.equal(sa[k], sb[k]):
            raise AssertionError(f"{name}: stat {k!r} differs")


def timed_run(engine, prog, g, pack, cfg):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, st = engine.run(prog, g, pack, cfg)
    torch.cuda.synchronize()
    return m, st, time.perf_counter() - t0


def profile_runs(engine, progs, g, pack, cfg, top: int = 8) -> None:
    """torch.profiler over one run of each program: device-busy share of the
    wall time and the kernels that hold the device longest."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else e.self_cuda_time_total

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        engine.run(progs[0][1], g, pack, cfg)      # profiler start-up, not reported
        torch.cuda.synchronize()
    for name, p in progs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.run(p, g, pack, cfg)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: an operator's entry repeats its kernels' time
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in ka)
        log(f"[profile] {name}: wall {wall_us / 1e3:.1f} ms (profiled), device busy "
            f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}%")
        for e in sorted(ka, key=dev_us, reverse=True)[:top]:
            log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22, help="RMAT scale of the main path")
    ap.add_argument("--grid", type=int, default=1024, help="grid2d side of phase 5")
    ap.add_argument("--quick", action="store_true", help="stop after phase 3")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one kernel-pull run of each main-path program")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import algorithms as A
    from repro_torch.core import engine as E
    from repro_torch.graph import generators as G
    from repro_torch.graph import pack_ell
    from repro_torch.graph.csr import from_edges
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ell_spmv as ell
    from repro_torch.kernels import frontier_pack as fp
    from repro_torch.kernels import segment_reduce as sr

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"[1 card] {card}")
    log(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        rep = _build.ptxas_report(name)
        regs = [int(x.split("registers")[0].split()[-1]) for x in rep.splitlines()
                if "registers" in x and "Used" in x]
        spills = [x.strip() for x in rep.splitlines()
                  if "spill" in x and not x.strip().startswith("0 bytes spill")
                  and " 0 bytes spill stores, 0 bytes spill loads" not in x]
        log(f"[2 build] {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, spill lines {len(spills)}")
    log(f"[2 build] nvcc build {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    err = {"ell_combine": sweep_ell(dev, rng, ell),
           "frontier_pack": sweep_pack(dev, rng, fp),
           "segment_reduce": sweep_segment(dev, rng, sr)}
    log(f"[3 kernels] sweeps passed; max abs err vs plain {err}")
    if args.quick:
        return 0

    # -- phase 4: the main path ------------------------------------------------
    t0 = time.perf_counter()
    src, dst, w = G.rmat_edges(args.scale, 16, 0.57, 0.19, 0.19, seed=1)
    t_draw = time.perf_counter() - t0
    g = from_edges(src, dst, 1 << args.scale, w, directed=False, device=dev)
    del src, dst, w
    pack = pack_ell(g.inc)
    torch.cuda.synchronize()
    n, m = g.n_nodes, g.n_edges
    log(f"[4 main] RMAT scale {args.scale}: n={n} m={m} slices="
        f"{[tuple(s.nbr.shape) for s in pack.slices]}; host draws {t_draw:.1f} s, "
        f"total build {time.perf_counter() - t0:.1f} s")

    # kernel times at the main path's shapes (these launches are not counted)
    report = {}
    vals = torch.rand(n + 1, device=dev) * 64
    slots = sum(s.nbr.numel() for s in pack.slices)
    rows = sum(s.rows for s in pack.slices)
    ell_k = lambda: [ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min") for s in pack.slices]
    ell_p = lambda: [ell.ell_combine_plain(s.nbr, s.wgt, vals, "add_w", "min") for s in pack.slices]
    e_err = max(abs_err(a, b) for a, b in zip(ell_k(), ell_p()))
    bnd = bound_ms(slots * 8 + (n + 1) * 4 + rows * 4, slots * 2)
    report["ell_combine"] = dict(
        source="src/repro_torch/csrc/ell_combine.cu",
        replaces="src/repro/kernels/ell_spmv.py:62",
        max_abs_err=max(e_err, err["ell_combine"]), ms=cuda_ms(ell_k, 10),
        plain_ms=cuda_ms(ell_p, 3, 1), bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=None)

    mask = torch.rand(n, device=dev) < 0.5
    pk = lambda: fp.frontier_pack_cuda(mask, n)
    pp = lambda: fp.frontier_pack_plain(mask, n)
    if not all(bit_equal(x, y) for x, y in zip(pk(), pp())):
        raise AssertionError("frontier_pack differs at the main path's shape")
    bnd = bound_ms(n + n * 4 + 5, n * 2)
    report["frontier_pack"] = dict(
        source="src/repro_torch/csrc/frontier_pack.cu",
        replaces="src/repro/kernels/frontier_pack.py:25",
        max_abs_err=err["frontier_pack"], ms=cuda_ms(pk), plain_ms=cuda_ms(pp, 5),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(lambda: torch.nonzero(mask), 5))

    sid = torch.sort(g.out.col_idx).values
    sv = torch.rand(m, device=dev)
    sk = lambda: sr.segment_reduce_cuda(sv, sid, n, "sum")
    sp = lambda: sr.segment_reduce_plain(sv, sid, n, "sum")
    a, b = sk(), sp()
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    if not bit_equal(a, sk()):
        raise AssertionError("segment_reduce sum not deterministic at the main path's shape")
    lib_out = torch.zeros(n, device=dev)
    sid64 = sid.long()
    bnd = bound_ms(m * 8 + n * 4, m)
    report["segment_reduce"] = dict(
        source="src/repro_torch/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce.py:20",
        max_abs_err=max(err["segment_reduce"], abs_err(a, b)),
        ms=cuda_ms(sk), plain_ms=cuda_ms(sp, 5), bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(lambda: lib_out.index_add_(0, sid64, sv), 5))
    del sid, sv, sid64, lib_out, vals, mask, a, b
    for k, r in report.items():
        log(f"[4 main] {k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")

    progs = [("bfs", A.bfs(0)), ("sssp", A.sssp(0)), ("wcc", A.wcc()),
             ("pagerank", A.pagerank()), ("kcore", A.kcore(16))]
    cfg_k = E.EngineConfig(frontier_cap=n, edge_cap=m, pull_impl="kernel", fusion="all")
    cfg_t = dataclasses.replace(cfg_k, pull_impl="torch")
    for _, p in progs:                       # warm-up (allocator, first launches)
        E.run(p, g, pack, cfg_k)
    torch.cuda.synchronize()

    ops.reset_launches()
    results = {}
    for name, p in progs:
        results[name] = timed_run(E, p, g, pack, cfg_k)
    launches = ops.launch_counts()
    log(f"[4 main] launches on the main path: {launches}")

    for name, p in progs:
        mk, sk_, tk = results[name]
        mt, st_, tt = timed_run(E, p, g, pack, cfg_t)
        same_run(name, mk, sk_, mt, st_)
        log(f"[4 main] {name}: kernel pull {tk:.3f} s, torch pull {tt:.3f} s, "
            f"iterations {int(sk_['iterations'])} (push {int(sk_['push_iters'])}, "
            f"pull {int(sk_['pull_iters'])}, switches {int(sk_['switches'])}); "
            "bit-equal to the torch pull")
    t0 = time.perf_counter()
    check_dist("bfs", results["bfs"][0]["dist"], scipy_dist(g, True), ell.BIG)
    check_dist("sssp", results["sssp"][0]["dist"], scipy_dist(g, False), ell.BIG)
    log(f"[4 main] bfs and sssp equal scipy's distances ({time.perf_counter() - t0:.1f} s)")
    del results
    if args.profile:
        profile_runs(E, progs, g, pack, cfg_k)
    del g, pack
    torch.cuda.empty_cache()

    # -- phase 5: high diameter ------------------------------------------------
    g2 = G.grid2d(args.grid, seed=5, device=dev)
    pack2 = pack_ell(g2.inc)
    if args.profile:     # the first 256 iterations bound the trace's size
        profile_runs(E, [("grid bfs, 256 iterations", A.bfs(0))], g2, pack2,
                     E.EngineConfig(frontier_cap=g2.n_nodes, edge_cap=g2.n_edges,
                                    max_iters=256))
    for name, p in (("bfs", A.bfs(0)), ("sssp", A.sssp(0))):
        ref = None
        for fusion in ("none", "all", "pushpull"):
            cfg = E.EngineConfig(frontier_cap=g2.n_nodes, edge_cap=g2.n_edges,
                                 fusion=fusion, max_iters=16384)
            mm, ss, tt = timed_run(E, p, g2, pack2, cfg)
            if int(ss["final_count"]) != 0:
                raise AssertionError(f"grid {name} {fusion}: did not converge")
            if ref is None:
                ref = (mm, ss)
                check_dist(f"grid {name}", mm["dist"], scipy_dist(g2, name == "bfs"), ell.BIG)
            else:
                same_run(f"grid {name} {fusion}", ref[0], ref[1], mm, ss)
            log(f"[5 diameter] grid2d({args.grid}) {name} fusion={fusion}: {tt:.3f} s, "
                f"iterations {int(ss['iterations'])} (push {int(ss['push_iters'])}, "
                f"pull {int(ss['pull_iters'])})")

    # -- phase 6: report -------------------------------------------------------
    kernels = []
    for name in _build.SOURCES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        kernels.append(dict(name=name, route="cuda", launches=launches[name],
                            passed=True, **report[name]))
    log(f"[6 report] total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
