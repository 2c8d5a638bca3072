#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run (RMAT scale 22)
    python3 chip_smoke.py --quick         # build + kernel sweeps only

Phases (any failure exits non-zero; nothing is caught):
  1. card      — nvidia-smi name and power limit, torch/CUDA versions;
  2. build     — nvcc builds every kernel (csrc/*.cu), one nvcc per source;
                 the tensor-core flash library's SASS (cuobjdump -sass) must
                 hold HGMMA (wgmma) and UTMALDG (TMA loads);
  3. kernels   — each CUDA kernel against its plain PyTorch version on the
                 card over shape sweeps (bit-equal for ell_combine, its
                 deletion overlay (also bit-equal to the kernel on the
                 neutralized copy), frontier_pack, min/max segment_reduce
                 and max embedding_bag; segment_reduce sum within rtol 1e-5
                 and identical from run to run); ell_spmm over ragged R,
                 W in {1, 3, 32, 256}, D in {8, 10, 64, 70, 128}, float32
                 (rtol 1e-5) and bfloat16 (rtol 1.6e-2); embedding_bag sum
                 and mean (rtol 1e-5); flash_attention over ragged Sq and
                 Skv (across the tensor-core kernel's 128-row tiles), Sq <
                 Skv (decode offsets over several kv tiles), causal and not,
                 float32 (2e-4) and bfloat16 (5e-2, and 1e-2 in relative
                 norm), each call on the route `flash_attention.route` names
                 (bf16 with D % 8 == 0: tensor cores; float32 and bf16 D = 12:
                 CUDA cores); in bfloat16 each is also held within
                 ROUNDED_REL_ERR (5e-3) in relative norm of
                 `attention_rounded`, the plain version that rounds where the
                 kernels do, and a control shows that dropping key 0 from
                 every row moves `attention_rounded` by more than twice that;
  4. main path — RMAT scale 22, edge factor 16 (Graph500 a/b/c 0.57/0.19/
                 0.19, seed 1, undirected): each kernel timed at the main
                 path's shapes, then bfs, sssp, wcc, pagerank and kcore(16)
                 through `engine.run` with the kernel pull, counted; each is
                 bit-equal to the torch pull (metadata, traces, iterations);
                 bfs and sssp equal scipy's distances;
  5. diameter  — grid2d(1024): bfs and sssp under fusion none/all/pushpull
                 give equal results, equal to scipy's;
  6. slice     — the kernel library's second slice at full width, through
                 `kernels.ops` and `nn.layers`, counted: (a) the deletion
                 overlay on phase 4's ELL slices with 1 % of the real slots
                 dead, bit-equal to the kernel on the neutralized copy and to
                 the plain version, all Compute x Combine ops; (b) ell_spmm
                 over the same slices at D = 64 (gin-tu) and D = 70
                 (gatedgcn); (c) embedding_bag over DeepFM's table (39 fields
                 x 100,000 rows x 10), B = 16,384, sum and mean; (d) one
                 granite-3-8b attention layer (d_model 4096, 32/8 heads,
                 head_dim 128, B = 4, S = 1024) through
                 `gqa_attention(use_flash=True)` against `use_flash=False`,
                 in bf16 (the tensor-core kernel) within 5e-2 and 1e-2 in
                 relative norm, and in float32 (the CUDA-core kernel) within
                 2e-4, each flash kernel alone likewise, the bf16 one also
                 within 5e-3 of `attention_rounded`; each kernel timed
                 beside its plain version and, where one exists, a single
                 PyTorch call;
  7. report    — the `kernels` JSON line (all eight kernels, flash as two
                 routes), the card line, then the last line
                 {"ok": true, "device": {...}}.

Kernel times are CUDA-event means over a run of calls. Kernels under 0.1 ms
(frontier_pack, embedding_bag) and their library calls (torch.nonzero_static,
F.embedding_bag) take the median of 7 event-timed batches of 50 calls
replayed from a CUDA graph: the card's time, without the Python function's
host time. Beside them are logged, for kernel and library call alike, the
median of 7 event-timed batches of 50 calls through the Python function
(torch.nonzero, which waits for its count on the host, for the library) and
the host time to enqueue one call.

It exits non-zero, printing no result, where torch.cuda.is_available() is
false or the package is missing beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # dense bf16 on the tensor cores (H100 SXM data sheet)


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


def cuda_ms(fn, iters: int = 20, warm: int = 3, batches: int = 1) -> float:
    """Time of one call of `fn` on the card: the median over `batches` of
    the mean of `iters` calls between CUDA events (several batches for
    kernels of tens of microseconds, whose single runs spread widely on a
    shared host)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[batches // 2]


def graph_ms(fn, batches: int = 7, per: int = 50) -> float:
    """Like `cuda_ms(fn, per, batches=batches)`, with the `per` calls
    captured once in a CUDA graph and replayed: the card's time for the
    calls, without the Python wrapper's host time (a kernel of ~10
    microseconds launched from Python is otherwise timed by the host's
    enqueue rate)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    return cuda_ms(graph.replay, 1, 1, batches) / per


def host_us(fn, calls: int = 200) -> float:
    """Host time to enqueue one call of `fn` (no synchronisation inside)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries that differ (equal infinities count 0)."""
    diff = torch.where(a == b, 0.0, (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over all entries, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_rel(what: str, a: torch.Tensor, b: torch.Tensor, limit: float) -> None:
    """Raise if `a` is further than `limit` from `b` in relative norm."""
    r = rel_err(a, b)
    if not r <= limit:
        raise AssertionError(f"{what}: relative norm error {r:.3g} > {limit}")


def dropped_key_control(fa, q, k, v, causal: bool, ref: torch.Tensor) -> float:
    """Relative norm by which dropping key 0 from every row moves
    `ref` = `attention_rounded(q, k, v, causal)`: the size of a fault the
    bfloat16 check must see (causal with Sq == Skv leaves out row 0, which
    would see no key)."""
    lo = 1 if causal and q.shape[2] == k.shape[2] else 0
    dropped = fa.attention_rounded(q[:, :, lo:], k[:, :, 1:], v[:, :, 1:], causal)
    return rel_err(dropped, ref[:, :, lo:])


def bound_ms(nbytes: float, ops: float, peak: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / peak * 1e3
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


def sweep_overlay(dev, rng, ell) -> float:
    """The deletion overlay: bit-equal to the plain version and to the
    kernel without a mask on the neutralized copy, for every op pair."""
    for r, w, n in [(8, 4, 50), (13, 4, 50), (37, 32, 100), (29, 256, 700),
                    (9, 3, 40), (100, 1, 60), (3001, 256, 5000)]:
        nbr = torch.from_numpy(rng.integers(0, n + 1, size=(r, w)).astype(np.int32)).to(dev)
        wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(dev)
        v = rng.random(n + 1).astype(np.float32)
        v[rng.random(n + 1) < 0.2] = ell.BIG
        vals = torch.from_numpy(v).to(dev)
        dead = torch.from_numpy(rng.random((r, w)) < 0.3).to(dev)
        neutral = ell.neutralize(nbr, dead, n)
        for op in ell.COMPUTE_OPS:
            for comb in ell.COMBINE_OPS:
                a = ell.ell_combine_cuda(nbr, wgt, vals, op, comb, dead.to(torch.int8))
                b = ell.ell_combine_plain(nbr, wgt, vals, op, comb, dead)
                c = ell.ell_combine_cuda(neutral, wgt, vals, op, comb)
                torch.cuda.synchronize()
                if not (bit_equal(a, b) and bit_equal(a, c)):
                    raise AssertionError(f"overlay {op}/{comb} R={r} W={w} n={n} differs")
    return 0.0


def sweep_spmm(dev, rng, ell) -> float:
    worst = 0.0
    for r, w, n in [(13, 1, 50), (40, 3, 90), (777, 32, 3000), (29, 256, 700), (1, 256, 300)]:
        nbr = torch.from_numpy(rng.integers(0, n + 1, size=(r, w)).astype(np.int32)).to(dev)
        wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(dev)
        for d in (8, 10, 64, 70, 128):
            f = rng.random((n + 1, d)).astype(np.float32)
            f[-1] = 0.0
            for dt in (torch.float32, torch.bfloat16):
                feats = torch.from_numpy(f).to(dev).to(dt)
                a = ell.ell_spmm_cuda(nbr, wgt, feats)
                b = ell.ell_spmm_plain(nbr, wgt, feats)
                torch.cuda.synchronize()
                if a.dtype != dt:
                    raise AssertionError(f"ell_spmm returned {a.dtype} for {dt}")
                tol = 1e-5 if dt == torch.float32 else 1.6e-2
                torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
                if dt == torch.float32:
                    worst = max(worst, abs_err(a, b))
    return worst


def sweep_bag(dev, rng, bag) -> float:
    worst = 0.0
    for v, d, b, k in [(1000, 10, 100, 39), (50, 64, 33, 4), (70, 70, 5, 1),
                       (300, 3, 17, 200), (500, 128, 64, 8), (40, 1, 9, 2), (90, 256, 3, 3)]:
        table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, v, size=(b, k)).astype(np.int32)).to(dev)
        for mode in bag.MODES:
            a = bag.embedding_bag_cuda(table, idx, mode)
            p = bag.embedding_bag_plain(table, idx, mode)
            torch.cuda.synchronize()
            if mode == "max":
                if not bit_equal(a, p):
                    raise AssertionError(f"embedding_bag max V={v} D={d} differs")
            else:
                torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-5)
                worst = max(worst, abs_err(a, p))
    return worst


def sweep_flash(dev, rng, fa, ops, rounded: dict) -> dict:
    """Both flash routes against the plain version; returns the worst
    absolute error of each kernel (bf16 for the tensor cores, float32 for
    the CUDA cores) and puts each kernel's worst bf16 relative norm error
    against `attention_rounded` into `rounded`."""
    worst = {fa.TENSOR_CORES: 0.0, fa.CUDA_CORES: 0.0}
    worst_rel, least_control = 0.0, float("inf")
    for b, hq, hkv, sq, skv, d in [(1, 2, 2, 32, 32, 16), (2, 4, 2, 64, 64, 32),
                                   (1, 8, 1, 100, 100, 64), (2, 4, 2, 16, 80, 32),
                                   (1, 4, 4, 70, 130, 128), (1, 2, 1, 1, 37, 24),
                                   (1, 32, 8, 200, 200, 128), (2, 6, 3, 65, 129, 8),
                                   (2, 4, 2, 200, 333, 64), (1, 6, 3, 300, 300, 128),
                                   (1, 4, 2, 130, 400, 128), (1, 4, 1, 257, 513, 96),
                                   (1, 4, 2, 150, 170, 12), (1, 32, 8, 1024, 1024, 128)]:
        shapes = ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
        base = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(x).to(dev).to(dt) for x in base)
            kernel = fa.route(dt, d)
            for causal in (True, False):
                ops.reset_launches()
                a = fa.flash_attention_cuda(q, k, v, causal)
                if ops.launch_counts()[kernel] != 1:
                    raise AssertionError(f"flash D={d} {dt} did not take the {kernel} route")
                p = fa.attention_plain(q, k, v, causal)
                torch.cuda.synchronize()
                tol = 2e-4 if dt == torch.float32 else 5e-2
                torch.testing.assert_close(a.float(), p.float(), rtol=tol, atol=tol)
                if dt == torch.float32 or kernel == fa.TENSOR_CORES:
                    worst[kernel] = max(worst[kernel], abs_err(a.float(), p.float()))
                if dt == torch.bfloat16:
                    what = f"flash B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} {causal=}"
                    check_rel(what, a, p, fa.BF16_REL_ERR)
                    worst_rel = max(worst_rel, rel_err(a, p))
                    r = fa.attention_rounded(q, k, v, causal)
                    check_rel(f"{what} vs attention_rounded", a, r, fa.ROUNDED_REL_ERR)
                    rounded[kernel] = max(rounded.get(kernel, 0.0), rel_err(a, r))
                    control = dropped_key_control(fa, q, k, v, causal, r)
                    if not control > 2 * fa.ROUNDED_REL_ERR:
                        raise AssertionError(f"{what}: a dropped key moves the output by "
                                             f"only {control:.3g}")
                    least_control = min(least_control, control)
    log(f"[3 kernels] flash_attention bfloat16: worst relative norm error {worst_rel:.3g} "
        f"against the plain version (limit {fa.BF16_REL_ERR}); against attention_rounded "
        f"{rounded} (limit {fa.ROUNDED_REL_ERR}); one dropped key moves attention_rounded by "
        f"at least {least_control:.3g}")
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


def slice_phase(dev, pack, ops, ell, bag, fa, L, report, err, rounded) -> dict:
    """Phase 6: the kernel library's second slice at full width. Drives the
    overlay, ell_spmm, embedding_bag and the flash kernel through `ops` and
    `nn.layers` with the counts set to 0 just before, checks every result,
    then times each kernel beside its plain version (uncounted). The
    granite layer runs in bf16 (the tensor-core flash kernel) and in float32
    (the CUDA-core one). Fills `report`; returns the five kernels' launch
    counts."""
    n, slices = pack.n_nodes, pack.slices
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    vals = torch.rand(n + 1, device=dev, generator=gen) * 64
    deads = [(torch.rand(tuple(s.nbr.shape), device=dev, generator=gen) < 0.01) & (s.nbr != n)
             for s in slices]
    feats = {}
    for d in (64, 70):                          # gin-tu, gatedgcn hidden widths
        feats[d] = torch.rand(n + 1, d, device=dev, generator=gen)
        feats[d][n] = 0.0
    fields, per_field, dim, nbag = 39, 100_000, 10, 16_384    # DeepFM (models/deepfm.py)
    table = torch.randn(fields * per_field, dim, device=dev, generator=gen)
    idx = (torch.arange(fields, device=dev, dtype=torch.int32) * per_field
           + torch.randint(0, per_field, (nbag, fields), device=dev, generator=gen,
                           dtype=torch.int32))
    d_model, hq, hkv, dh, batch, seq = 4096, 32, 8, 128, 4, 1024   # granite-3-8b
    bf16 = torch.bfloat16

    def weight(rows, cols):
        return (torch.randn(rows, cols, device=dev, generator=gen) * rows ** -0.5).to(bf16)

    params = {"wq": weight(d_model, hq * dh), "wk": weight(d_model, hkv * dh),
              "wv": weight(d_model, hkv * dh), "wo": weight(hq * dh, d_model),
              "attn_norm": torch.ones(d_model, device=dev, dtype=bf16)}
    x = torch.randn(batch, seq, d_model, device=dev, generator=gen).to(bf16)
    pos = torch.arange(seq, device=dev, dtype=torch.int32).expand(batch, seq)
    combos = [(op, comb) for op in ell.COMPUTE_OPS for comb in ell.COMBINE_OPS]
    torch.cuda.synchronize()

    # -- the counted run ------------------------------------------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    over = {c: [ops.ell_combine(s.nbr, s.wgt, vals, *c, dead=dd) for s, dd in zip(slices, deads)]
            for c in combos}
    spmm = {d: [ops.ell_spmm(s.nbr, s.wgt, f) for s in slices] for d, f in feats.items()}
    bags = {mode: ops.embedding_bag(table, idx, mode) for mode in ("sum", "mean")}
    h = L.rms_norm(x, params["attn_norm"])
    attn, (k, v) = L.gqa_attention(h, params, n_heads=hq, n_kv=hkv, positions=pos,
                                   use_flash=True)
    p32 = {key: w.float() for key, w in params.items()}
    a32, _ = L.gqa_attention(h.float(), p32, n_heads=hq, n_kv=hkv, positions=pos,
                             use_flash=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    mine = {key: counts[key] for key in
            ("ell_combine_overlay", "ell_spmm", "embedding_bag", fa.TENSOR_CORES, fa.CUDA_CORES)}
    log(f"[6 slice] counted run {time.perf_counter() - t0:.3f} s; launches {mine}")

    # -- (a) deletion overlay -------------------------------------------------
    real = sum(int((s.nbr != n).sum()) for s in slices)
    n_dead = sum(int(dd.sum()) for dd in deads)
    neutral = [ell.neutralize(s.nbr, dd, n) for s, dd in zip(slices, deads)]
    for c, outs in over.items():
        for s, dd, nu, o in zip(slices, deads, neutral, outs):
            if not bit_equal(o, ell.ell_combine_cuda(nu, s.wgt, vals, *c)):
                raise AssertionError(f"overlay {c} differs from the neutralized copy")
            if not bit_equal(o, ell.ell_combine_plain(s.nbr, s.wgt, vals, *c, dd)):
                raise AssertionError(f"overlay {c} differs from its plain version")
    log(f"[6 slice] (a) overlay: {n_dead} of {real} real slots dead "
        f"({100 * n_dead / real:.3f} %); {len(combos)} op pairs x {len(slices)} slices "
        "bit-equal to the neutralized copy and to the plain version")
    slots = sum(s.nbr.numel() for s in slices)
    rows = sum(s.rows for s in slices)
    ovk = lambda: [ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min", dd)
                   for s, dd in zip(slices, deads)]
    ovp = lambda: [ell.ell_combine_plain(s.nbr, s.wgt, vals, "add_w", "min", dd)
                   for s, dd in zip(slices, deads)]
    bnd = bound_ms(slots * 9 + (n + 1) * 4 + rows * 4, slots * 2)
    report["ell_combine_overlay"] = dict(
        replaces="src/repro/kernels/ell_spmv.py:74",
        shape=f"{len(slices)} RMAT ELL slices, {slots} slots, add_w/min, 1 % dead",
        max_abs_err=err["ell_combine_overlay"], ms=cuda_ms(ovk, 10),
        plain_ms=cuda_ms(ovp, 3, 1), bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    del over, neutral, deads

    # -- (b) ell_spmm ---------------------------------------------------------
    used = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    for s in slices:
        used[s.nbr.flatten().long()] = True
    used_rows = int(used[:n].sum())
    csrs = []
    for s in slices:
        live = s.nbr != n
        crow = torch.zeros(s.rows + 1, dtype=torch.int32, device=dev)
        crow[1:] = live.sum(dim=1).cumsum(0)
        csrs.append(torch.sparse_csr_tensor(crow, s.nbr[live], s.wgt[live],
                                            size=(s.rows, n + 1)))
    e_err, times = 0.0, {}
    for d, f in feats.items():
        lib_diff = 0.0
        for s, o, c in zip(slices, spmm[d], csrs):
            b = ell.ell_spmm_plain(s.nbr, s.wgt, f)
            torch.testing.assert_close(o, b, rtol=1e-5, atol=1e-5)
            e_err = max(e_err, abs_err(o, b))
            lib_diff = max(lib_diff, abs_err(o, torch.sparse.mm(c, f)))
        sk = lambda f=f: [ell.ell_spmm_cuda(s.nbr, s.wgt, f) for s in slices]
        sp = lambda f=f: [ell.ell_spmm_plain(s.nbr, s.wgt, f) for s in slices]
        sl = lambda f=f: [torch.sparse.mm(c, f) for c in csrs]
        times[d] = (cuda_ms(sk, 5), cuda_ms(sp, 1, 0), cuda_ms(sl, 5), lib_diff)
        log(f"[6 slice] (b) ell_spmm D={d}: {times[d][0]:.4f} ms (plain {times[d][1]:.4f}, "
            f"torch.sparse.mm {times[d][2]:.4f}, max |kernel - sparse.mm| {lib_diff:.3g})")
    del spmm, csrs
    d = 64
    bnd = bound_ms(slots * 8 + used_rows * d * 4 + rows * d * 4, 2 * real * d)
    report["ell_spmm"] = dict(
        replaces="src/repro/kernels/ell_spmv.py:150",
        shape=f"{len(slices)} RMAT ELL slices, {real} live slots, D=64 float32 "
              f"(D=70: {times[70][0]:.4f} ms, plain {times[70][1]:.4f}, library {times[70][2]:.4f})",
        max_abs_err=max(e_err, err["ell_spmm"]), ms=times[d][0], plain_ms=times[d][1],
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=times[d][2])

    # -- (c) embedding_bag ----------------------------------------------------
    idx64 = idx.long()
    b_err = 0.0
    for mode, o in bags.items():
        pl = bag.embedding_bag_plain(table, idx, mode)
        torch.testing.assert_close(o, pl, rtol=1e-5, atol=1e-5)
        b_err = max(b_err, abs_err(o, pl))
        lib_diff = abs_err(o, F.embedding_bag(idx64, table, mode=mode))
        log(f"[6 slice] (c) embedding_bag {mode}: within rtol 1e-5 of plain "
            f"(max abs err {abs_err(o, pl):.3g}); max |kernel - F.embedding_bag| {lib_diff:.3g}")
    uniq = int(torch.unique(idx).numel())
    bnd = bound_ms(uniq * dim * 4 + idx.numel() * 4 + nbag * dim * 4, nbag * fields * dim)
    report["embedding_bag"] = dict(
        replaces="src/repro/kernels/embedding_bag.py:24",
        shape=f"table {fields * per_field}x{dim} float32, B={nbag}, K={fields}, sum",
        max_abs_err=max(b_err, err["embedding_bag"]),
        ms=graph_ms(lambda: bag.embedding_bag_cuda(table, idx, "sum")),
        plain_ms=cuda_ms(lambda: bag.embedding_bag_plain(table, idx, "sum"), 5),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=graph_ms(lambda: F.embedding_bag(idx64, table, mode="sum")),
        wrapper_loop_ms=cuda_ms(lambda: bag.embedding_bag_cuda(table, idx, "sum"), 50, 5, 7),
        library_loop_ms=cuda_ms(lambda: F.embedding_bag(idx64, table, mode="sum"), 50, 5, 7))
    r = report["embedding_bag"]
    log(f"[6 slice] (c) embedding_bag sum: card {r['ms']:.4f} ms against F.embedding_bag's "
        f"{r['library_ms']:.4f} ms (both CUDA graphs); through the Python function "
        f"{r['wrapper_loop_ms']:.4f} ms against {r['library_loop_ms']:.4f} ms a call")
    del bags, table, idx, idx64

    # -- (d) the granite-3-8b attention layer --------------------------------
    # Outputs here are small (a row averages many values of v: rms ~0.12), so
    # bfloat16 is held by the relative norm and float32 at 2e-4 absolute.
    plain, _ = L.gqa_attention(h, params, n_heads=hq, n_kv=hkv, positions=pos, use_flash=False)
    if attn.shape != (batch, seq, d_model) or not bool(torch.isfinite(attn).all()):
        raise AssertionError("granite attention layer: wrong shape or non-finite values")
    b32, _ = L.gqa_attention(h.float(), p32, n_heads=hq, n_kv=hkv, positions=pos,
                             use_flash=False)
    log(f"[6 slice] (d) granite-3-8b attention layer B={batch} S={seq}: use_flash=True vs "
        f"False in bfloat16 max abs diff {abs_err(attn.float(), plain.float()):.3g}, relative "
        f"norm {rel_err(attn, plain):.3g} (limit {fa.BF16_REL_ERR}); in float32 max abs diff "
        f"{abs_err(a32, b32):.3g} (limit 2e-4), relative norm {rel_err(a32, b32):.3g}; "
        f"output rms {float(plain.float().square().mean().sqrt()):.3g}")
    torch.testing.assert_close(attn.float(), plain.float(), rtol=5e-2, atol=5e-2)
    check_rel("granite attention layer (bfloat16)", attn, plain, fa.BF16_REL_ERR)
    torch.testing.assert_close(a32, b32, rtol=2e-4, atol=2e-4)
    del p32, a32, b32
    q = L.rope((h @ params["wq"]).reshape(batch, seq, hq, dh), pos).transpose(1, 2).contiguous()
    k, v = k.contiguous(), v.contiguous()
    q32, k32, v32 = q.float(), k.float(), v.float()
    a, pl = fa.flash_attention_cuda(q, k, v, True), fa.attention_plain(q, k, v, True)
    a32, p32 = fa.flash_attention_cuda(q32, k32, v32, True), fa.attention_plain(q32, k32, v32, True)
    kr, vr = k.repeat(1, hq // hkv, 1, 1), v.repeat(1, hq // hkv, 1, 1)   # group-major
    kr32, vr32 = kr.float(), vr.float()
    lib = F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
    log(f"[6 slice] (d) flash vs plain in bfloat16 (tensor cores) max abs diff "
        f"{abs_err(a.float(), pl.float()):.3g}, relative norm {rel_err(a, pl):.3g}; in float32 "
        f"(CUDA cores) max abs diff {abs_err(a32, p32):.3g}, relative norm "
        f"{rel_err(a32, p32):.3g}; "
        f"output rms {float(pl.float().square().mean().sqrt()):.3g}; "
        f"vs scaled_dot_product_attention {abs_err(a.float(), lib.float()):.3g}")
    torch.testing.assert_close(a.float(), pl.float(), rtol=5e-2, atol=5e-2)
    check_rel("flash kernel (bfloat16, tensor cores)", a, pl, fa.BF16_REL_ERR)
    torch.testing.assert_close(a32, p32, rtol=2e-4, atol=2e-4)
    r = fa.attention_rounded(q, k, v, True)
    control = dropped_key_control(fa, q, k, v, True, r)
    log(f"[6 slice] (d) flash (bfloat16, tensor cores) vs attention_rounded: relative norm "
        f"{rel_err(a, r):.3g} (limit {fa.ROUNDED_REL_ERR}); key 0 dropped from every row "
        f"moves attention_rounded by {control:.3g}")
    check_rel("flash kernel (bfloat16, tensor cores) vs attention_rounded", a, r,
              fa.ROUNDED_REL_ERR)
    if not control > 2 * fa.ROUNDED_REL_ERR:
        raise AssertionError(f"granite: a dropped key moves the output by only {control:.3g}")
    rounded[fa.TENSOR_CORES] = max(rounded[fa.TENSOR_CORES], rel_err(a, r))
    del r
    pairs = batch * hq * seq * (seq + 1) // 2          # causal (query, key) pairs
    shape = f"granite-3-8b layer: q {tuple(q.shape)}, kv {tuple(k.shape)}, causal"
    for kernel, qq, kk, vv, kx, vx, peak, what, e in (
            (fa.TENSOR_CORES, q, k, v, kr, vr, BF16_OPS_PER_S, "bf16",
             abs_err(a.float(), pl.float())),
            (fa.CUDA_CORES, q32, k32, v32, kr32, vr32, F32_OPS_PER_S, "float32",
             abs_err(a32, p32))):
        bnd = bound_ms((qq.numel() * 2 + kk.numel() * 2) * qq.element_size(), 4 * pairs * dh,
                       peak)
        report[kernel] = dict(
            replaces="src/repro/kernels/flash_attention.py:28",
            shape=f"{shape}, {what}",
            max_abs_err=max(e, err[kernel]), bf16_rounded_rel_err=rounded[kernel],
            ms=cuda_ms(lambda: fa.flash_attention_cuda(qq, kk, vv, True), 10),
            plain_ms=cuda_ms(lambda: fa.attention_plain(qq, kk, vv, True), 3, 1),
            bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qq, kx, vx, is_causal=True),
                               10))
    del q32, k32, v32, kr32, vr32, a32, p32
    for key in mine:
        r = report[key]
        log(f"[6 slice] {key}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    return mine


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
    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import frontier_pack as fp
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.nn import layers as L

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
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
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", rep)]
        log(f"[2 build] {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, max {max(smem, default=0)} bytes of static shared memory, "
            f"spill lines {len(spills)}")
    log(f"[2 build] nvcc build {time.perf_counter() - t0:.1f} s")
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
         str(_build._lib_path(_build.KERNELS[fa.TENSOR_CORES]))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    found = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[2 build] {_build.KERNELS[fa.TENSOR_CORES]} SASS: {found}")
    if not all(found.values()):
        raise AssertionError(f"the tensor-core flash kernel lacks wgmma or TMA loads: {found}")

    rng = np.random.default_rng(0)
    rounded = {}
    err = {"ell_combine": sweep_ell(dev, rng, ell),
           "ell_combine_overlay": sweep_overlay(dev, rng, ell),
           "frontier_pack": sweep_pack(dev, rng, fp),
           "segment_reduce": sweep_segment(dev, rng, sr),
           "ell_spmm": sweep_spmm(dev, rng, ell),
           "embedding_bag": sweep_bag(dev, rng, bag),
           **sweep_flash(dev, rng, fa, ops, rounded)}
    log(f"[3 kernels] sweeps passed; max abs err vs plain (float32) {err}")
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
    lib = lambda: torch.nonzero_static(mask, size=n, fill_value=n)   # int64 ids, no count
    lib_loop = lambda: torch.nonzero(mask)                           # waits for its count
    if not torch.equal(pk()[0].long(), lib()[:, 0]):
        raise AssertionError("frontier_pack and torch.nonzero_static disagree")
    report["frontier_pack"] = dict(
        replaces="src/repro/kernels/frontier_pack.py:25",
        max_abs_err=err["frontier_pack"], ms=graph_ms(pk), plain_ms=cuda_ms(pp, 5),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=graph_ms(lib),
        wrapper_loop_ms=cuda_ms(pk, 50, 5, 7), library_loop_ms=cuda_ms(lib_loop, 50, 5, 7),
        host_us=host_us(pk), library_host_us=host_us(lib_loop))
    r = report["frontier_pack"]
    log(f"[4 main] frontier_pack n={n} density 0.5: card {r['ms']:.4f} ms against "
        f"torch.nonzero_static's {r['library_ms']:.4f} ms (both CUDA graphs); through the "
        f"Python function {r['wrapper_loop_ms']:.4f} ms a call with {r['host_us']:.1f} us of "
        f"host enqueue, torch.nonzero {r['library_loop_ms']:.4f} ms a call with "
        f"{r['library_host_us']:.1f} us")

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
    del g                       # phase 6 runs on the ELL slices
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

    # -- phase 6: the second slice at full width ----------------------------
    launches.update(slice_phase(dev, pack, ops, ell, bag, fa, L, report, err, rounded))
    del pack
    torch.cuda.empty_cache()

    # -- phase 7: report -------------------------------------------------------
    kernels = []
    for name in _build.KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append(dict(name=name, route="cuda",
                            source=f"src/repro_torch/csrc/{_build.KERNELS[name]}.cu",
                            launches=launches[name], passed=True, **report[name]))
    log(f"[7 report] total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
