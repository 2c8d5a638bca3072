#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run (RMAT scale 22)
    python3 chip_smoke.py --quick         # build + kernel sweeps only

Phases (any failure exits non-zero; nothing is caught):
  1. card      — nvidia-smi name and power limit, torch/CUDA versions;
  2. build     — nvcc builds every kernel (csrc/*.cu), one nvcc per source;
                 the wgmma flash library's SASS (cuobjdump -sass) must hold
                 HGMMA (wgmma) and UTMALDG (TMA loads), the TF32 flash
                 library's TF32 tensor-core instructions (HMMA...TF32),
                 ell_combine's and ell_spmm's LDG.E.128 (16-byte loads);
                 registers and spills of the TF32 flash kernel and ell_spmm
                 (ptxas -v), the main path's instances by name;
  3. kernels   — each CUDA kernel against its plain PyTorch version on the
                 card over shape sweeps: ell_combine bit-equal at W in
                 {1, 2, 3, 4, 5, 8, 12, 16, 32, 64, 128, 256}, both its
                 16-byte and scalar variants (views 4 bytes into their
                 storage among them); its deletion overlay bit-equal to the
                 plain version and to the kernel on the neutralized copy;
                 frontier_pack bit-equal; segment_reduce bit-equal to
                 segment_reduce_ordered (its fold order) for sum, min and
                 max, at segment lengths on each side of every tier limit,
                 D in {1, 3, 64}, num far above E, every id out of range and
                 E = 0, bit-equal to the plain version for min/max and for
                 sum within rtol 1e-5 of it run in float64, identical from
                 run to run; embedding_bag with ids from [-V - 3, V + 3),
                 max bit-equal to the plain version, sum and mean bit-equal
                 to `embedding_bag_ordered` (its fold order) and to a second
                 call and within rtol 1e-5 of the plain version; ell_spmm
                 over ragged R,
                 W in {1, 3, 4, 8, 32, 256}, D in {8, 10, 64, 70, 128}, float32
                 (rtol 1e-5) and bfloat16 (rtol 1.6e-2), with sentinels
                 anywhere in a row (a slice with none live among them), on
                 each layout `spmm_layout` picks (views 4 bytes into their
                 storage among them), each call repeated bit for bit;
                 flash_attention over ragged Sq and
                 Skv (across the tensor-core kernel's 128-row tiles), Sq <
                 Skv (decode offsets over several kv tiles), causal and not,
                 float32 (2e-4) and bfloat16 (5e-2, and 1e-2 in relative
                 norm), each call on the route `flash_attention.route` names
                 (bf16 with D % 8 == 0: wgmma; float32 and bf16 D = 12: the
                 TF32 kernel, in float32 also within 2e-4 of
                 `attention_3xtf32`, its plain version, and one decode row,
                 Sq = 1, Skv = 2048, among the shapes); in bfloat16 each is
                 also held within
                 ROUNDED_REL_ERR (5e-3) in relative norm of
                 `attention_rounded`, the plain version that rounds where the
                 kernels do, and a control shows that dropping key 0 from
                 every row moves `attention_rounded` by more than twice that;
  4. main path — RMAT scale 22, edge factor 16 (Graph500 a/b/c 0.57/0.19/
                 0.19, seed 1, undirected): each kernel timed at the main
                 path's shapes (ell_combine per slice, all 12 op pairs
                 bit-equal there; segment_reduce at the push Combine's shape
                 and at each slice's pull-merge shape, each bit-equal to
                 segment_reduce_ordered), then bfs, sssp, wcc, pagerank and
                 kcore(16) through `engine.run` with the kernel pull,
                 counted (segment_reduce's launches split into one a push and
                 one a slice a pull); each is bit-equal to the torch pull
                 (metadata, traces, iterations); bfs and sssp equal scipy's
                 distances;
  5. diameter  — grid2d(1024): bfs and sssp under fusion none/all/pushpull
                 give equal results, equal to scipy's;
  6. slice     — the kernel library's second slice at full width, through
                 `kernels.ops` and `nn.layers`, counted: (a) the deletion
                 overlay on phase 4's ELL slices with 1 % of the real slots
                 dead, bit-equal to the kernel on the neutralized copy and to
                 the plain version, all Compute x Combine ops; (b) ell_spmm
                 over the same slices at D = 64 (gin-tu) and D = 70
                 (gatedgcn); (c) embedding_bag over DeepFM's table (39 fields
                 x 100,000 rows x 10), B = 512, 16,384 and 262,144, sum and
                 mean, each bit-equal to `embedding_bag_ordered` and timed
                 beside its bound by bytes and by 32-byte sectors; (d) one
                 granite-3-8b attention layer (d_model 4096, 32/8 heads,
                 head_dim 128, B = 4, S = 1024) through
                 `gqa_attention(use_flash=True)` against `use_flash=False`,
                 in bf16 (the wgmma kernel) within 5e-2 and 1e-2 in
                 relative norm, and in float32 (the TF32 kernel) within
                 2e-4, each flash kernel alone likewise, the bf16 one also
                 within 5e-3 of `attention_rounded`; ell_spmm on each slice
                 bit-equal to a second call; each kernel timed beside its
                 plain version and, where one exists, a single PyTorch call
                 (float32 scaled_dot_product_attention's kernels named by
                 torch.profiler); the TF32 flash kernel's bound is three
                 TF32 products a product at 495 TFLOP/s, its CUDA-core
                 bound beside it, ell_spmm's bound beside the one without
                 padding weights and its rate of row requests;
  7. report    — the `kernels` JSON line (all eight kernels, flash as two
                 routes), the card line, then the last line
                 {"ok": true, "device": {...}}.

Kernel times are CUDA-event means over a run of calls. Kernels under 0.1 ms
(frontier_pack, embedding_bag, the segment_reduce merges) and their library
calls (torch.nonzero_static, F.embedding_bag, index_add_, scatter_reduce_)
take the median of 7 event-timed batches of 50 calls
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
import collections
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
TF32_OPS_PER_S = 495e12        # dense TF32 on the tensor cores (H100 SXM data sheet)
BF16_OPS_PER_S = 989e12        # dense bf16 on the tensor cores (H100 SXM data sheet)
#: embedding_bag's batches over DeepFM's table: serve_p99 and serve_bulk
#: (src/repro/configs/registry.py:37-38), and 16,384 between them
BAG_BATCHES = (512, 16_384, 262_144)


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


def rel_max(a: torch.Tensor, exact: torch.Tensor) -> float:
    """Largest |a - exact| / |exact| over entries, in float64."""
    d = (a.double() - exact).abs() / exact.abs().clamp(min=1e-30)
    return float(d.max()) if d.numel() else 0.0


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


def ptxas_instances(report: str) -> list[tuple[str, int, int]]:
    """(mangled name, spill bytes, registers) of each kernel in nvcc's
    `-Xptxas -v` report."""
    found = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                       r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
                       r"(\d+) registers", report)
    return [(name, int(st) + int(ld), int(regs)) for name, st, ld, regs in found]


def bound_ms(nbytes: float, ops: float, peak: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def sweep_ell(dev, rng, ell) -> float:
    """ell_combine bit-equal to its plain version for every op pair, over
    widths on both variants: the 16-byte one (W % 4 == 0, aligned) and the
    scalar one (other widths, and views that start 4 bytes in)."""
    shapes = [(8, 4, 50), (64, 16, 200), (128, 32, 1000), (24, 256, 300),
              (13, 4, 50), (37, 32, 100), (29, 256, 700), (100, 1, 60),
              (9, 3, 40), (17, 64, 90), (11, 128, 90), (5, 8, 30), (1, 2, 10),
              (40, 5, 60), (21, 12, 70), (3001, 256, 5000)]
    unaligned = [(13, 4, 50), (37, 32, 100), (29, 256, 700), (9, 3, 40), (40, 5, 60)]
    worst = 0.0
    for (r, w, n), shift in [(x, 0) for x in shapes] + [(x, 1) for x in unaligned]:
        nb = rng.integers(0, n + 1, size=r * w + shift).astype(np.int32)
        wg = rng.random(r * w + shift).astype(np.float32)
        # a view `shift` elements into its storage (4 bytes: not 16-aligned)
        nbr = torch.from_numpy(nb).to(dev)[shift:].view(r, w)
        wgt = torch.from_numpy(wg).to(dev)[shift:].view(r, w)
        vec = ell.vector_layout(w, nbr.data_ptr(), wgt.data_ptr())
        if vec != (w % 4 == 0 and shift == 0):
            raise AssertionError(f"ell_combine W={w} shift={shift}: vector layout {vec}")
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
                    raise AssertionError(f"ell_combine {op}/{comb} R={r} W={w} n={n} "
                                         f"shift={shift} differs")
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


def segment_cases(rng, sr) -> list:
    """(E, D, ids, num) cases for segment_reduce: segment lengths on each side
    of every tier limit (1, THREAD_SEG and one more, 32, 33, LONG_SEG and one
    more), long ones first and last, gaps (empty segments), ids out of range
    at both ends; num far above E; every id out of range; E = 0; and random
    draws."""
    edges = [1, sr.THREAD_SEG, sr.THREAD_SEG + 1, 32, 33, sr.LONG_SEG, sr.LONG_SEG + 1]
    cases = []
    for d in (1, 3, 64):
        lens = edges + [int(x) for x in rng.integers(1, 70, 40)] + edges[::-1]
        lens = [sr.LONG_SEG + 1] + lens + [5000, sr.LONG_SEG + 1]
        seg = np.cumsum(rng.integers(1, 4, len(lens)))          # gaps of 0 .. 2
        num = int(seg[-1]) + 3
        ids = np.concatenate([[-5, -1], np.repeat(seg, lens), [num, num + 7]])
        cases.append((d, ids.astype(np.int32), num))
    sparse = np.sort(rng.choice(1_000_000, 1000, replace=False))
    cases.append((1, np.repeat(sparse, rng.integers(1, 12, 1000)).astype(np.int32), 1_000_003))
    cases.append((3, np.array([-3, -2, 9, 9, 12], np.int32), 9))       # all out of range
    cases.append((1, np.full(4000, 20, np.int32), 10))                 # all past num
    cases.append((1, np.zeros(0, np.int32), 7))                        # E = 0
    cases.append((64, np.zeros(0, np.int32), 7))
    for e, d, s, oob in [(256, 4, 16, 0), (2048, 16, 64, 0), (512, 8, 10, 0),
                         (1000, 1, 50, 0), (20000, 1, 5, 0), (50, 1, 100, 0),
                         (3000, 1, 40, 3), (9000, 2, 3, 0), (0, 1, 7, 0)]:
        cases.append((d, np.sort(rng.integers(-oob, s + oob, size=e)).astype(np.int32), s))
    return cases


def check_segment(sr, vals, sid, num, what: str) -> float:
    """segment_reduce on the card against segment_reduce_ordered (bit-equal,
    sum, min and max) and segment_reduce_plain (bit-equal for min/max; for
    sum within rtol 1e-5 of the plain version run in float64, since the
    float32 plain version's `index_add_` adds in an order that changes from
    run to run and strays by more than that on a hub of 10^5 rows); twice
    for sum, bit-equal. Returns the worst |kernel - plain| of the sums."""
    worst = 0.0
    for comb in ("min", "max", "sum"):
        for fill in (None, float("inf") if comb == "min" else float("-inf")):
            a = sr.segment_reduce_cuda(vals, sid, num, comb, fill)
            o = sr.segment_reduce_ordered(vals, sid, num, comb, fill)
            b = sr.segment_reduce_plain(vals, sid, num, comb, fill)
            torch.cuda.synchronize()
            if not bit_equal(a, o):
                raise AssertionError(f"segment_reduce {comb} {what} differs from "
                                     "segment_reduce_ordered")
            if comb == "sum":
                if not bit_equal(a, sr.segment_reduce_cuda(vals, sid, num, comb, fill)):
                    raise AssertionError(f"segment_reduce sum {what} not deterministic")
                exact = sr.segment_reduce_plain(vals.double(), sid, num, comb, fill)
                torch.testing.assert_close(a.double(), exact, rtol=1e-5, atol=1e-6)
                worst = max(worst, abs_err(a, b))
                if what.startswith("at the") and fill is None:
                    log(f"[4 main] segment_reduce sum {what}: largest relative error against "
                        f"float64, kernel {rel_max(a, exact):.3g}, float32 plain version "
                        f"{rel_max(b, exact):.3g}")
            elif not bit_equal(a, b):
                raise AssertionError(f"segment_reduce {comb} {what} differs from plain")
    return worst


def sweep_segment(dev, rng, sr) -> float:
    worst = 0.0
    for d, ids, num in segment_cases(rng, sr):
        e = ids.shape[0]
        v = rng.random((e, d)).astype(np.float32)
        vals = torch.from_numpy(v[:, 0] if d == 1 else v).to(dev).contiguous()
        sid = torch.from_numpy(ids).to(dev)
        worst = max(worst, check_segment(sr, vals, sid, num, f"E={e} D={d} num={num}"))
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
    """ell_spmm against its plain version over widths, feature widths and
    types, with a third of the slots sentinels at random places in their
    rows (and a slice with no live slot); each layout `spmm_layout` picks:
    16-byte ids on aligned W % 4 == 0 slices, 4-byte ones on other widths
    and on views 4 bytes into their storage; 16-, 8-, 4- or 2-byte feature
    loads by D, type and alignment (a feature view 4 bytes in among them).
    Each call is repeated and must give the same bits."""
    worst = 0.0
    cases = [(13, 1, 50, 0, 0.3), (40, 3, 90, 0, 0.3), (777, 32, 3000, 0, 0.3),
             (29, 256, 700, 0, 0.3), (1, 256, 300, 0, 0.3), (64, 4, 80, 0, 0.0),
             (37, 32, 100, 1, 0.3), (29, 256, 700, 1, 0.5), (50, 8, 60, 0, 1.0)]
    for r, w, n, shift, sent in cases:
        nb = rng.integers(0, n, size=r * w + shift).astype(np.int32)
        nb[rng.random(r * w + shift) < sent] = n         # sentinels anywhere in a row
        nbr = torch.from_numpy(nb).to(dev)[shift:].view(r, w)
        wgt = torch.from_numpy(rng.random(r * w + shift).astype(np.float32)).to(dev)
        wgt = wgt[shift:].view(r, w)
        for d in (8, 10, 64, 70, 128):
            f = rng.random((n + 2, d)).astype(np.float32)
            f[n] = 0.0
            for dt in (torch.float32, torch.bfloat16):
                for fshift in ((0, 1) if d == 64 else (0,)):
                    # (n + 1, D) rows, `fshift` elements into their storage
                    feats = torch.from_numpy(f).to(dev).to(dt).flatten()
                    feats = feats[fshift:fshift + (n + 1) * d].view(n + 1, d)
                    a = ell.ell_spmm_cuda(nbr, wgt, feats)
                    vec, fvec = ell.spmm_layout(w, d, dt, nbr.data_ptr(), wgt.data_ptr(),
                                                feats.data_ptr(), a.data_ptr())
                    if vec != (w % 4 == 0 and shift == 0):
                        raise AssertionError(f"ell_spmm W={w} shift={shift}: vec_ids {vec}")
                    if fshift and fvec != 1:
                        raise AssertionError(f"ell_spmm D={d} {dt} view: {fvec} columns a load")
                    b = ell.ell_spmm_plain(nbr, wgt, feats)
                    again = ell.ell_spmm_cuda(nbr, wgt, feats)
                    torch.cuda.synchronize()
                    if a.dtype != dt:
                        raise AssertionError(f"ell_spmm returned {a.dtype} for {dt}")
                    if not bit_equal(a, again):
                        raise AssertionError(f"ell_spmm R={r} W={w} D={d} {dt} not "
                                             "deterministic")
                    tol = 1e-5 if dt == torch.float32 else 1.6e-2
                    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
                    if dt == torch.float32:
                        worst = max(worst, abs_err(a, b))
    return worst


def sweep_bag(dev, rng, bag) -> float:
    """embedding_bag with ids drawn from [-V - 3, V + 3) (wrapped, then
    clamped): sum and mean bit-equal to `embedding_bag_ordered` (its fold
    order) and to a second call, within rtol 1e-5 of the plain version; max
    bit-equal to the plain version."""
    worst = 0.0
    for v, d, b, k in [(1000, 10, 100, 39), (50, 64, 33, 4), (70, 70, 5, 1),
                       (300, 3, 17, 200), (500, 128, 64, 8), (40, 1, 9, 2), (90, 256, 3, 3),
                       (2000, 10, 4001, 39), (80, 10, 13, 1)]:
        table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(-v - 3, v + 3, size=(b, k)).astype(np.int32)).to(dev)
        for mode in bag.MODES:
            a = bag.embedding_bag_cuda(table, idx, mode)
            p = bag.embedding_bag_plain(table, idx, mode)
            torch.cuda.synchronize()
            if mode == "max":
                if not bit_equal(a, p):
                    raise AssertionError(f"embedding_bag max V={v} D={d} differs")
            else:
                if not bit_equal(a, bag.embedding_bag_ordered(table, idx, mode)):
                    raise AssertionError(f"embedding_bag {mode} V={v} D={d} K={k} differs "
                                         "from embedding_bag_ordered")
                if not bit_equal(a, bag.embedding_bag_cuda(table, idx, mode)):
                    raise AssertionError(f"embedding_bag {mode} V={v} D={d} not deterministic")
                torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-5)
                worst = max(worst, abs_err(a, p))
    return worst


def sweep_flash(dev, rng, fa, ops, rounded: dict) -> dict:
    """Both flash routes against the plain version; returns the worst
    absolute error of each kernel (bf16 for wgmma, float32 for the TF32
    kernel) and puts each kernel's worst bf16 relative norm error against
    `attention_rounded` into `rounded`. The TF32 kernel in float32 is also
    held within 2e-4 of `attention_3xtf32`; what a single TF32 pass
    (`attention_3xtf32(passes=1)`) would give is logged, not held."""
    worst = {fa.TENSOR_CORES: 0.0, fa.TF32: 0.0}
    worst_rel, least_control = 0.0, float("inf")
    one_pass, three_pass = 0.0, 0.0
    for b, hq, hkv, sq, skv, d in [(1, 2, 2, 32, 32, 16), (2, 4, 2, 64, 64, 32),
                                   (1, 8, 1, 100, 100, 64), (2, 4, 2, 16, 80, 32),
                                   (1, 4, 4, 70, 130, 128), (1, 2, 1, 1, 37, 24),
                                   (1, 32, 8, 200, 200, 128), (2, 6, 3, 65, 129, 8),
                                   (2, 4, 2, 200, 333, 64), (1, 6, 3, 300, 300, 128),
                                   (1, 4, 2, 130, 400, 128), (1, 4, 1, 257, 513, 96),
                                   (1, 4, 2, 150, 170, 12), (1, 32, 8, 1024, 1024, 128),
                                   (1, 8, 2, 1, 2048, 128)]:
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
                if dt == torch.float32:
                    t3 = fa.attention_3xtf32(q, k, v, causal)
                    torch.testing.assert_close(a, t3, rtol=2e-4, atol=2e-4)
                    three_pass = max(three_pass, abs_err(t3, p))
                    one_pass = max(one_pass, abs_err(fa.attention_3xtf32(q, k, v, causal, 1), p))
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
    log(f"[3 kernels] flash_attention float32: worst |attention_3xtf32 - plain| "
        f"{three_pass:.3g}; a single TF32 pass (attention_3xtf32 passes=1) would give "
        f"{one_pass:.3g} (limit 2e-4, not held)")
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


def check_bags(bag, table, idx, bags, report, err) -> None:
    """Phase 6(c): each batch of BAG_BATCHES (a prefix of `idx`, one id a
    field of DeepFM's table), sum and mean from the counted run `bags`,
    bit-equal to `embedding_bag_ordered` and within rtol 1e-5 of the plain
    version; each timed beside its bound by bytes (each distinct row once)
    and by the 32-byte sectors those rows touch, the plain version and
    F.embedding_bag. Fills report["embedding_bag"] (the middle batch's sum
    at the top, every batch under `sizes`)."""
    fields, dim = idx.shape[1], table.shape[1]
    b_err, sizes = 0.0, []
    for nb in BAG_BATCHES:
        ids = idx[:nb]
        ids64 = ids.long()
        for mode in ("sum", "mean"):
            o = bags[(nb, mode)]
            if not bit_equal(o, bag.embedding_bag_ordered(table, ids, mode)):
                raise AssertionError(f"embedding_bag {mode} B={nb} differs from "
                                     "embedding_bag_ordered")
            pl = bag.embedding_bag_plain(table, ids, mode)
            torch.testing.assert_close(o, pl, rtol=1e-5, atol=1e-5)
            b_err = max(b_err, abs_err(o, pl))
            lib_diff = abs_err(o, F.embedding_bag(ids64, table, mode=mode))
            log(f"[6 slice] (c) embedding_bag B={nb} {mode}: bit-equal to "
                f"embedding_bag_ordered, within rtol 1e-5 of plain (max abs err "
                f"{abs_err(o, pl):.3g}); max |kernel - F.embedding_bag| {lib_diff:.3g}")
        rows = torch.unique(ids).long()
        start = rows * (dim * 4)                                  # byte offset of each row
        sectors = int(((start + dim * 4 - 1) // 32 - start // 32 + 1).sum())
        other = ids.numel() * 4 + nb * dim * 4                    # ids and output
        bnd = bound_ms(rows.numel() * dim * 4 + other, nb * fields * dim)
        size = dict(
            batch=nb, distinct_rows=rows.numel(), sectors=sectors,
            ms=graph_ms(lambda: bag.embedding_bag_cuda(table, ids, "sum")),
            mean_ms=graph_ms(lambda: bag.embedding_bag_cuda(table, ids, "mean")),
            plain_ms=cuda_ms(lambda: bag.embedding_bag_plain(table, ids, "sum"), 5),
            library_ms=graph_ms(lambda: F.embedding_bag(ids64, table, mode="sum")),
            library_mean_ms=graph_ms(lambda: F.embedding_bag(ids64, table, mode="mean")),
            bound_ms=bnd[0], bound_by=bnd[1],
            sector_bound_ms=bound_ms(sectors * 32 + other, nb * fields * dim)[0])
        if nb == BAG_BATCHES[1]:
            size.update(
                wrapper_loop_ms=cuda_ms(lambda: bag.embedding_bag_cuda(table, ids, "sum"),
                                        50, 5, 7),
                library_loop_ms=cuda_ms(lambda: F.embedding_bag(ids64, table, mode="sum"),
                                        50, 5, 7))
        sizes.append(size)
        log(f"[6 slice] (c) embedding_bag B={nb}: card {size['ms']:.4f} ms sum, "
            f"{size['mean_ms']:.4f} mean (CUDA graphs); bound {size['bound_ms']:.4f} by bytes "
            f"({rows.numel()} distinct rows), {size['sector_bound_ms']:.4f} by 32-byte sectors "
            f"({sectors}); plain {size['plain_ms']:.4f}; F.embedding_bag "
            f"{size['library_ms']:.4f} sum, {size['library_mean_ms']:.4f} mean")
    main = sizes[1]
    report["embedding_bag"] = dict(
        replaces="src/repro/kernels/embedding_bag.py:24",
        shape=f"table {table.shape[0]}x{dim} float32, B={main['batch']}, K={fields}, sum "
              f"(B={BAG_BATCHES}: `sizes`)",
        max_abs_err=max(b_err, err["embedding_bag"]),
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "sector_bound_ms", "wrapper_loop_ms", "library_loop_ms")},
        sizes=sizes)
    r = report["embedding_bag"]
    log(f"[6 slice] (c) embedding_bag B={main['batch']} sum through the Python function "
        f"{r['wrapper_loop_ms']:.4f} ms against F.embedding_bag's {r['library_loop_ms']:.4f} "
        "ms a call")


def slice_phase(dev, pack, ops, ell, bag, fa, L, report, err, rounded) -> dict:
    """Phase 6: the kernel library's second slice at full width. Drives the
    overlay, ell_spmm, embedding_bag and the flash kernel through `ops` and
    `nn.layers` with the counts set to 0 just before, checks every result,
    then times each kernel beside its plain version (uncounted). The
    granite layer runs in bf16 (the tensor-core flash kernel) and in float32
    (the TF32 one). Fills `report`; returns the five kernels' launch
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
    fields, per_field, dim = 39, 100_000, 10            # DeepFM (models/deepfm.py)
    table = torch.randn(fields * per_field, dim, device=dev, generator=gen)
    # one id a field; each batch of BAG_BATCHES is a prefix of one draw
    idx = (torch.arange(fields, device=dev, dtype=torch.int32) * per_field
           + torch.randint(0, per_field, (max(BAG_BATCHES), fields), device=dev,
                           generator=gen, dtype=torch.int32))
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
    bags = {(nb, mode): ops.embedding_bag(table, idx[:nb], mode)
            for nb in BAG_BATCHES for mode in ("sum", "mean")}
    h = L.rms_norm(x, params["attn_norm"])
    attn, (k, v) = L.gqa_attention(h, params, n_heads=hq, n_kv=hkv, positions=pos,
                                   use_flash=True)
    p32 = {key: w.float() for key, w in params.items()}
    a32, _ = L.gqa_attention(h.float(), p32, n_heads=hq, n_kv=hkv, positions=pos,
                             use_flash=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    mine = {key: counts[key] for key in
            ("ell_combine_overlay", "ell_spmm", "embedding_bag", fa.TENSOR_CORES, fa.TF32)}
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
    # ids and flags of every slot, weights of the live ones
    bnd = bound_ms(slots * 5 + (real - n_dead) * 4 + (n + 1) * 4 + rows * 4, (real - n_dead) * 2)
    report["ell_combine_overlay"] = dict(
        replaces="src/repro/kernels/ell_spmv.py:74",
        shape=f"{len(slices)} RMAT ELL slices, {slots} slots, add_w/min, 1 % dead",
        max_abs_err=err["ell_combine_overlay"], ms=cuda_ms(ovk, 10),
        plain_ms=cuda_ms(ovp, 3, 1), bound_ms=bnd[0], bound_by=bnd[1],
        bound_all_slots_ms=bound_ms(slots * 9 + (n + 1) * 4 + rows * 4, slots * 2)[0],
        library_ms=None)
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
            if not bit_equal(o, ell.ell_spmm_cuda(s.nbr, s.wgt, f)):
                raise AssertionError(f"ell_spmm D={d} on the {tuple(s.nbr.shape)} slice "
                                     "differs between two calls")
            e_err = max(e_err, abs_err(o, b))
            lib_diff = max(lib_diff, abs_err(o, torch.sparse.mm(c, f)))
        sk = lambda f=f: [ell.ell_spmm_cuda(s.nbr, s.wgt, f) for s in slices]
        sp = lambda f=f: [ell.ell_spmm_plain(s.nbr, s.wgt, f) for s in slices]
        sl = lambda f=f: [torch.sparse.mm(c, f) for c in csrs]
        times[d] = (cuda_ms(sk, 5), cuda_ms(sp, 1, 0), cuda_ms(sl, 5), lib_diff)
        log(f"[6 slice] (b) ell_spmm D={d}: {times[d][0]:.4f} ms (plain {times[d][1]:.4f}, "
            f"torch.sparse.mm {times[d][2]:.4f}, max |kernel - sparse.mm| {lib_diff:.3g}); "
            f"bit-equal to itself on a second call; row requests {real * d * 4 / 1e9:.2f} GB "
            f"= {real * d * 4 / times[d][0] / 1e9:.3f} TB/s")
    del spmm, csrs
    d = 64
    # every slot's id and weight (the first bound), or the weights of the
    # live slots only (what the kernel reads); each used row once; the output
    bnd = bound_ms(slots * 8 + used_rows * d * 4 + rows * d * 4, 2 * real * d)
    live_bnd = bound_ms(slots * 4 + real * 4 + used_rows * d * 4 + rows * d * 4, 2 * real * d)
    report["ell_spmm"] = dict(
        replaces="src/repro/kernels/ell_spmv.py:150",
        shape=f"{len(slices)} RMAT ELL slices, {real} live slots, D=64 float32 "
              f"(D=70: {times[70][0]:.4f} ms, plain {times[70][1]:.4f}, library {times[70][2]:.4f})",
        max_abs_err=max(e_err, err["ell_spmm"]), ms=times[d][0], plain_ms=times[d][1],
        bound_ms=bnd[0], bound_by=bnd[1], bound_live_weights_ms=live_bnd[0],
        request_tb_per_s=real * d * 4 / times[d][0] / 1e9,
        request_tb_per_s_d70=real * 70 * 4 / times[70][0] / 1e9, library_ms=times[d][2])

    # -- (c) embedding_bag ----------------------------------------------------
    check_bags(bag, table, idx, bags, report, err)
    del bags, table, idx

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
        f"(TF32) max abs diff {abs_err(a32, p32):.3g}, relative norm "
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q32, kr32, vr32, is_causal=True)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    log(f"[6 slice] (d) float32 scaled_dot_product_attention runs {names}")
    # the TF32 kernel does three TF32 products for each float32 one
    for kernel, qq, kk, vv, kx, vx, ops_x, peak, what, e in (
            (fa.TENSOR_CORES, q, k, v, kr, vr, 1, BF16_OPS_PER_S, "bf16",
             abs_err(a.float(), pl.float())),
            (fa.TF32, q32, k32, v32, kr32, vr32, 3, TF32_OPS_PER_S, "float32, 3xTF32",
             abs_err(a32, p32))):
        nbytes = (qq.numel() * 2 + kk.numel() * 2) * qq.element_size()
        bnd = bound_ms(nbytes, ops_x * 4 * pairs * dh, peak)
        report[kernel] = dict(
            replaces="src/repro/kernels/flash_attention.py:28",
            shape=f"{shape}, {what}",
            max_abs_err=max(e, err[kernel]), bf16_rounded_rel_err=rounded[kernel],
            ms=cuda_ms(lambda: fa.flash_attention_cuda(qq, kk, vv, True), 10),
            plain_ms=cuda_ms(lambda: fa.attention_plain(qq, kk, vv, True), 3, 1),
            bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qq, kx, vx, is_causal=True),
                               10))
    report[fa.TF32].update(
        bound_cuda_cores_ms=bound_ms(nbytes, 4 * pairs * dh, F32_OPS_PER_S)[0],
        library_kernels=names)
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
    def sass_of(source: str) -> str:
        return subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(_build._lib_path(source))],
            capture_output=True, text=True, check=True, timeout=120).stdout

    sass = sass_of(_build.KERNELS[fa.TENSOR_CORES])
    found = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[2 build] {_build.KERNELS[fa.TENSOR_CORES]} SASS: {found}")
    if not all(found.values()):
        raise AssertionError(f"the tensor-core flash kernel lacks wgmma or TMA loads: {found}")
    for source in ("ell_combine", "ell_spmm"):
        sass = sass_of(source)
        wide = sass.count("LDG.E.128")
        narrow = len(re.findall(r"LDG\.E(?:\.CONSTANT)?\s", sass))
        log(f"[2 build] {source} SASS: LDG.E.128 {wide}, 32-bit LDG.E {narrow}")
        if not wide:
            raise AssertionError(f"{source} has no 128-bit global loads (LDG.E.128)")
    sass = sass_of(_build.KERNELS[fa.TF32])
    tf32 = collections.Counter(re.findall(r"HMMA\.\S*TF32\S*", sass))
    log(f"[2 build] {_build.KERNELS[fa.TF32]} SASS: {dict(tf32)}")
    if not tf32:
        raise AssertionError("the TF32 flash kernel has no TF32 tensor-core instructions")
    # registers and spills of every instance; the main path's by name:
    # flash_kernel<float, DP = 128, causal, cp.async>; spmm_kernel<float, V, L, C>
    # at D = 64 (V = 4, L = 16, C = 1) and D = 70 (V = 2, L = 16, C = 3)
    for source, main in ((_build.KERNELS[fa.TF32], "flash_kernelIfLi128ELb1ELb1E"),
                         ("ell_spmm", "spmm_kernelIfLi4ELi16ELi1E"),
                         ("ell_spmm", "spmm_kernelIfLi2ELi16ELi3E")):
        per = ptxas_instances(_build.ptxas_report(source))
        regs = sorted({x[2] for x in per})
        spill = sum(x[1] for x in per)
        on_path = [f"{x[2]} registers, {x[1]} spill bytes" for x in per if main in x[0]]
        log(f"[2 build] {source}: {len(per)} instances, registers {regs[:1] + regs[-1:]} "
            f"(least, most), spill bytes {spill}; main path's {main}: {on_path}")

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
    real = sum(int((s.nbr != n).sum()) for s in pack.slices)
    e_err, per_slice = 0.0, []
    for s in pack.slices:
        r_, w_ = s.nbr.shape
        if not ell.vector_layout(w_, s.nbr.data_ptr(), s.wgt.data_ptr()):
            raise AssertionError(f"the ({r_}, {w_}) slice does not take the 16-byte variant")
        for op in ell.COMPUTE_OPS:
            for comb in ell.COMBINE_OPS:
                a = ell.ell_combine_cuda(s.nbr, s.wgt, vals, op, comb)
                if not bit_equal(a, ell.ell_combine_plain(s.nbr, s.wgt, vals, op, comb)):
                    raise AssertionError(f"ell_combine {op}/{comb} differs on the ({r_}, {w_}) slice")
        b = ell.ell_combine_plain(s.nbr, s.wgt, vals, "add_w", "min")
        e_err = max(e_err, abs_err(ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min"), b))
        rl = int((s.nbr != n).sum())
        b_all = bound_ms(s.nbr.numel() * 8 + (n + 1) * 4 + r_ * 4, 2 * s.nbr.numel())
        b_real = bound_ms(s.nbr.numel() * 4 + rl * 4 + (n + 1) * 4 + r_ * 4, 2 * rl)
        per_slice.append(dict(
            shape=[r_, w_], real_slots=rl,
            ms=cuda_ms(lambda s=s: ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min"), 10),
            bound_ms=b_real[0], bound_all_slots_ms=b_all[0]))
        log(f"[4 main] ell_combine slice ({r_}, {w_}), {rl} real slots: "
            f"{per_slice[-1]['ms']:.4f} ms (bound {b_real[0]:.4f} without padding weights, "
            f"{b_all[0]:.4f} for all slots); 12 op pairs bit-equal to the plain version")
    ell_k = lambda: [ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min") for s in pack.slices]
    ell_p = lambda: [ell.ell_combine_plain(s.nbr, s.wgt, vals, "add_w", "min") for s in pack.slices]
    bnd = bound_ms(slots * 4 + real * 4 + (n + 1) * 4 + rows * 4, real * 2)
    report["ell_combine"] = dict(
        replaces="src/repro/kernels/ell_spmv.py:62",
        shape=f"{len(pack.slices)} RMAT ELL slices, {slots} slots ({real} real), add_w/min",
        max_abs_err=max(e_err, err["ell_combine"]), ms=cuda_ms(ell_k, 10),
        plain_ms=cuda_ms(ell_p, 3, 1), bound_ms=bnd[0], bound_by=bnd[1],
        bound_all_slots_ms=bound_ms(slots * 8 + (n + 1) * 4 + rows * 4, slots * 2)[0],
        slices=per_slice, library_ms=None)

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

    # segment_reduce: the push Combine's shape (E = m, num = n) ...
    sid = torch.sort(g.out.col_idx).values
    sv = torch.rand(m, device=dev)
    s_err = check_segment(sr, sv, sid, n, "at the push shape")
    sid64 = sid.long()
    lib_out = torch.zeros(n, device=dev)
    bnd = bound_ms(m * 8 + n * 4, m)
    report["segment_reduce"] = dict(
        replaces="src/repro/kernels/segment_reduce.py:20",
        shape=f"push Combine: E={m} sorted ids, num={n}, sum",
        max_abs_err=max(err["segment_reduce"], s_err),
        ms=cuda_ms(lambda: sr.segment_reduce_cuda(sv, sid, n, "sum")),
        plain_ms=cuda_ms(lambda: sr.segment_reduce_plain(sv, sid, n, "sum"), 5),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(lambda: lib_out.index_add_(0, sid64, sv), 5),
        library_min_ms=cuda_ms(lambda: lib_out.scatter_reduce_(0, sid64, sv, "amin"), 5))
    del sid, sv, sid64, lib_out
    # ... and each pull merge's (E = the slice's rows, num = n + 1)
    merges = []
    lib_out = torch.zeros(n + 1, device=dev)
    for s in pack.slices:
        part = torch.rand(s.rows, device=dev)
        what = f"at the merge shape E={s.rows}"
        s_err = max(s_err, check_segment(sr, part, s.row_id, n + 1, what))
        rid64 = s.row_id.long()
        bnd = bound_ms(s.rows * 8 + (n + 1) * 4, s.rows)
        merges.append(dict(
            rows=s.rows, ms=graph_ms(lambda: sr.segment_reduce_cuda(part, s.row_id, n + 1, "sum")),
            plain_ms=cuda_ms(lambda: sr.segment_reduce_plain(part, s.row_id, n + 1, "sum"), 5),
            bound_ms=bnd[0],
            library_ms=graph_ms(lambda: lib_out.index_add_(0, rid64, part)),
            library_min_ms=graph_ms(lambda: lib_out.scatter_reduce_(0, rid64, part, "amin")),
            loop_ms=cuda_ms(lambda: sr.segment_reduce_cuda(part, s.row_id, n + 1, "sum"), 50, 5, 7)))
        r = merges[-1]
        log(f"[4 main] segment_reduce merge E={s.rows} num={n + 1}: card {r['ms']:.4f} ms "
            f"(CUDA graph; {r['loop_ms']:.4f} through Python), bound {r['bound_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, index_add_ {r['library_ms']:.4f}, scatter_reduce_ amin "
            f"{r['library_min_ms']:.4f}; bit-equal to segment_reduce_ordered")
    report["segment_reduce"].update(merges=merges, max_abs_err=max(
        report["segment_reduce"]["max_abs_err"], s_err))
    del lib_out, part, rid64, vals, mask
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
    pushes = sum(int(results[k][1]["push_iters"]) for k in results)
    pulls = sum(int(results[k][1]["pull_iters"]) for k in results)
    if launches["segment_reduce"] != pushes + len(pack.slices) * pulls:
        raise AssertionError(f"segment_reduce launched {launches['segment_reduce']} times for "
                             f"{pushes} pushes and {pulls} pulls")
    report["segment_reduce"].update(launches_push=pushes,
                                    launches_merge=len(pack.slices) * pulls)

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
