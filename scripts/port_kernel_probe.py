#!/usr/bin/env python3
"""Design probes for the port's CUDA kernels, on one NVIDIA GPU.

    python3 scripts/port_kernel_probe.py tiles
    python3 scripts/port_kernel_probe.py pack
    python3 scripts/port_kernel_probe.py wrappers [--root DIR]
    python3 scripts/port_kernel_probe.py combine [--root DIR] [--parent DIR]
    python3 scripts/port_kernel_probe.py tiers
    python3 scripts/port_kernel_probe.py flash32 [--root DIR] [--parent DIR]
    python3 scripts/port_kernel_probe.py spmm [--root DIR] [--parent DIR]
    python3 scripts/port_kernel_probe.py bag [--root DIR] [--parent DIR]
    python3 scripts/port_kernel_probe.py bagvar [--parent DIR]
    python3 scripts/port_kernel_probe.py batched [--root DIR] [--parent DIR]
    python3 scripts/port_kernel_probe.py flashbwd [--root DIR] [--parent DIR]

tiles    — builds `csrc/flash_attention_wgmma.cu` with -DFLASH_WGMMA_PROBE
           into `build/probe/` (the same kernel, whose kv-tile width and
           ring depth the exported `flash_attention_wgmma_probe` takes at
           run time), prints its ptxas registers, checks each variant (BKV in
           {64, 128} x STAGES in {2, 3}) against `attention_rounded` in
           relative norm (`ROUNDED_REL_ERR`) on shapes that cross its tiles,
           and times it at granite-3-8b's layer (B = 4, 32 / 8 heads,
           S = 1024, causal, bf16) at D = 128 and D = 64 beside
           `scaled_dot_product_attention`: two rounds, CUDA events.
pack     — at n = 2^22, density 0.5, cap = n: the device time of each
           operation of one `frontier_pack` call and of one `torch.nonzero`
           (torch.profiler).
wrappers — the two kernels under 0.1 ms, `frontier_pack` (n = 2^22,
           density 0.5, cap = n) and `embedding_bag` (DeepFM: 39 x 100,000
           rows x 10, B = 16,384, sum), and their library calls, each on
           three yardsticks of chip_smoke.py: the card's time for 50 calls
           replayed from a CUDA graph, the time of a loop of calls through
           the Python function (both the median of 7 event-timed batches of
           50 calls), and the host time to enqueue one call. The kernels come
           from the `repro_torch` under DIR/src (default: this checkout), so
           that an earlier commit unpacked into DIR is timed in the same way;
           run it for both, in the order parent, change, change, parent.
combine  — the engine's two Combine kernels at the main path's shapes
           (RMAT scale 22, edge factor 16, seed 1, undirected):
           `segment_reduce` at the push Combine's shape (E = m sorted ids,
           num = n, sum), at a push whose frontier covers 1 % of the edge
           lanes (the rest hold the sentinel n, as in `engine._push_step`),
           and at each ELL slice's pull-merge shape (E = the slice's rows,
           num = n + 1); `ell_combine` on each slice (add_w / min). Times
           are CUDA-event means (the merges: replays of a CUDA graph of 50
           calls, median of 7). The kernels come from the `repro_torch`
           under DIR/src; with --parent, the tree under that DIR is timed in
           the same process and on the same inputs, in turns (parent,
           change, change, parent), its ell_combine held bit-equal and its
           segment_reduce sums within rtol 1e-5 of this tree's. Last, the
           device time of each kernel of this tree's push calls
           (torch.profiler).
tiers    — builds `csrc/segment_reduce.cu` with other thread-tier limits
           (-DSEG_THREAD_SEG) and chunk depths (-DSEG_UNROLL) into
           `build/probe/`, holds each bit-equal to `segment_reduce_ordered`
           at its limit (sum, min) at RMAT-22's push shape and one merge,
           and times each there (CUDA events; the merge by CUDA graph).
flash32  — `flash_attention_cuda` in float32 (the `flash_attention_f32`
           route) at granite-3-8b's layer (B = 4, 32 / 8 heads of 128,
           S = 1024, causal) and at one decode row (Sq = 1, Skv = 2048),
           beside float32 `scaled_dot_product_attention` (kv heads repeated
           group-major), each held within 2e-4 of `attention_plain`; then
           the library call's kernels by name, and the device time of each
           kernel of this tree's call (the K/V split pre-pass and the
           attention kernel) at both shapes (torch.profiler). The kernels
           come from the `repro_torch` under DIR/src; with --parent, the tree
           under that DIR is timed in the same process and on the same
           inputs, in turns (parent, change, change, parent). CUDA events.
spmm     — `ell_spmm` over the four ELL slices of RMAT scale 22 (edge
           factor 16, seed 1, undirected) at D = 64 and D = 70, float32,
           beside `torch.sparse.mm` on the same slices as CSR, each held
           within rtol 1e-5 of the first tree's output; per slice and all
           four; --root and --parent as for flash32. Last, this tree's
           kernel on the same slices with every live id replaced by a
           uniform draw from [0, n): the rate of row requests when hubs
           give L2 nothing to reuse. CUDA events.
bag      — `embedding_bag_cuda` on DeepFM's table (39 x 100,000 rows x 10,
           one id a field) at B = 512, 16,384 and 262,144, sum and mean,
           beside `F.embedding_bag` and an empty kernel (built here into
           `build/probe/`: one block, and the grid the kernel launches at
           B = 512), all by CUDA-graph replay (median of 7 batches of 50);
           each output within rtol 1e-5 of the first tree's, the change's
           bit-equal to its `embedding_bag_ordered`; then, for each batch,
           a replay whose every call takes a new window of bags (rows that
           L2 does not hold, as for a server's next batch); --root and
           --parent as for flash32.
bagvar   — builds copies of `csrc/embedding_bag.cu` with other gathers in
           flight a lane, threads a block, register caps and row groups a
           bag (`BAG_VARIANTS`) into `build/probe/`, and the parent's source
           with --parent; holds each bit-equal to `embedding_bag_ordered`
           (for its number of row groups) at DeepFM's three batch sizes, then
           times each on ids confined to 19.5 MB of rows (L2 holds them),
           and twice on the whole table (same bags each call, and a new
           window each call). CUDA-graph replay.
batched  — `ell_combine_batched_cuda` on the four ELL slices of RMAT scale
           22 (edge factor 16, seed 1, undirected) at Q = 8 and 64, copy/sum
           and add_w/min, per slice and all four; --root and --parent as
           for flash32 (parent, change, change, parent on the same inputs),
           each output bit-equal to the first tree's. Then this tree's
           kernel on every layout it takes (`candidate_layouts`: slot lanes
           with L lanes a row, column lanes with S slot groups) at Q = 4, 8,
           16, 32 and 64, copy/sum, slice by slice, each bit-equal to the
           plain version: what `batched_layout` should pick.
           Last, the control: every live id replaced by a uniform draw from
           [0, n), copy/sum at Q = 8 and 64; its gap to the real ids is the
           L2 reuse that the hubs give. CUDA events.
flashbwd — the flash backward in bf16 at granite-moe-1b-a400m's layer (B =
           8, 16 / 8 heads of 64, S = 1024, causal) and granite-3-8b's (B =
           2, 32 / 8 heads of 128), and in float32 at the 100m preset's
           layer (B = 8, 12 / 6 heads of 64, S = 128, causal) and
           granite-moe's, as `flash_attention_bwd_cuda` takes it in each tree
           (with the forward's lse where the tree's backward takes one, else
           without), each call's (dq, dk, dv) against `attention_bwd_rounded`
           (bf16, relative norm) or `attention_bwd_plain` (float32, max |a -
           p| over max |p|, within BWD_F32_ERR); --root and --parent as for
           flash32 (parent, change, change, parent on the same inputs). Then
           this tree's forwards with and without `with_lse` (wgmma for bf16;
           TF32 for float32, beside its bound and float32
           `scaled_dot_product_attention`), and its backwards split by
           kernel (the Delta pass, dK/dV, dQ: torch.profiler device time).
           Last, the TF32 backward built with other tiles at D <= 64
           (`BWD_VARIANTS`: warps a block, rows a streamed tile;
           -DFLASH_BWD_WARPS, -DFLASH_BWD_STEP) into `build/probe/`, the
           registers and spill bytes of their float32 Dh 64 causal
           instances, each held to `attention_bwd_plain` and timed at the
           two float32 shapes in two rounds. CUDA events.

It fails where there is no GPU or a variant does not build or disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (BAG_BATCHES, bound_ms, card_line, cuda_ms, graph_ms,  # noqa: E402
                        host_us)
from repro_torch.kernels.tuning import H100, parse_ptxas  # noqa: E402

#: the probe entry's C parameters: flash_attention_wgmma_launch's (lse
#: after the output), with the kv-tile width and the ring depth before the
#: stream
PROBE_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
VARIANTS = [(64, 2), (64, 3), (128, 2), (128, 3)]     # (BKV, STAGES); (64, 2) ships
#: the TF32 backward's tiles at D <= 64: (warps a block, rows of the streamed
#: tile); (4, 32) ships
BWD_VARIANTS = [(4, 32), (2, 16), (4, 16), (2, 32)]


def log(msg: str) -> None:
    print(msg, flush=True)


def import_port(root: Path):
    # chip_smoke imported this checkout's package for its constants: drop
    # it, so that the package under root is the one imported
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[2] != root.resolve():
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree under {root}")
    return repro_torch


def flash_tiles(dev) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    out = _build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libflash_attention_wgmma_probe.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_WGMMA_PROBE", "-o",
                           str(lib), str(_build.CSRC / "flash_attention_wgmma.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the probe build failed:\n{(proc.stdout + proc.stderr)[-3000:]}")
    report = proc.stdout + proc.stderr
    # flash_wgmma<DP, BKV, STAGES, CAUSAL>, as the mangled name spells it
    for k in parse_ptxas(report):
        m = re.search(r"flash_wgmmaILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E", k.name)
        if m:
            dp, bkv, stages, causal = m.groups()
            log(f"[tiles] ptxas: D panel {dp}, bkv={bkv} stages={stages} causal={causal}: "
                f"{k.registers} registers")
    fn = ctypes.CDLL(str(lib)).flash_attention_wgmma_probe
    fn.argtypes = list(PROBE_ARGTYPES)
    fn.restype = ctypes.c_int

    def run(bkv, stages, q, k, v, causal=True):
        b, hq, sq, d = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b, hq,
                 k.shape[1], sq, k.shape[2], d, 1.0 / d ** 0.5, int(causal), bkv, stages,
                 _build.stream_of(dev))
        _build.check(err, f"flash probe bkv={bkv} stages={stages}")
        return o

    rng = np.random.default_rng(0)
    cases = []
    for b, hq, hkv, sq, skv, d in [(2, 4, 2, 200, 333, 64), (1, 4, 2, 130, 400, 128),
                                   (1, 4, 1, 257, 513, 96), (2, 2, 1, 150, 150, 8),
                                   (1, 32, 8, 1024, 1024, 128)]:
        cases.append([torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                      .to(torch.bfloat16)
                      for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))])
    for bkv, stages in VARIANTS:
        worst = 0.0
        for q, k, v in cases:
            for causal in (True, False):
                a = run(bkv, stages, q, k, v, causal).float()
                r = fa.attention_rounded(q, k, v, causal).float()
                worst = max(worst, float((a - r).norm() / r.norm()))
        if not worst <= fa.ROUNDED_REL_ERR:
            raise AssertionError(f"bkv={bkv} stages={stages}: relative norm error {worst:.3g}")
        log(f"[tiles] bkv={bkv} stages={stages}: worst relative norm error against "
            f"attention_rounded {worst:.3g}")
    q = torch.randn(4, 32, 1024, 128, device=dev).to(torch.bfloat16)
    k = torch.randn(4, 8, 1024, 128, device=dev).to(torch.bfloat16)
    v = torch.randn(4, 8, 1024, 128, device=dev).to(torch.bfloat16)
    kr, vr = k.repeat(1, 4, 1, 1), v.repeat(1, 4, 1, 1)               # group-major
    half = [t[..., :64].contiguous() for t in (q, k, v)]
    for rnd in range(2):
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
                       20, 3, 5)
        log(f"[tiles] round {rnd}: scaled_dot_product_attention D=128 {sdpa:.4f} ms")
        for bkv, stages in VARIANTS:
            full = cuda_ms(lambda: run(bkv, stages, q, k, v), 20, 3, 5)
            narrow = cuda_ms(lambda: run(bkv, stages, *half), 20, 3, 5)
            log(f"[tiles] round {rnd}: bkv={bkv} stages={stages} D=128 {full:.4f} ms, "
                f"D=64 {narrow:.4f} ms")


def pack_breakdown(dev) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import frontier_pack as fp

    n = 1 << 22
    mask = torch.rand(n, device=dev) < 0.5
    for what, fn in (("frontier_pack", lambda: fp.frontier_pack_cuda(mask, n)),
                     ("torch.nonzero", lambda: torch.nonzero(mask))):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                total += us / 50
                log(f"[pack] {what}: {e.key[:60]} {us / 50:.2f} us a call")
        log(f"[pack] {what}: device {total:.2f} us a call")


def wrappers(dev, root: Path) -> None:
    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import frontier_pack as fp

    n = 1 << 22
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    mask = torch.rand(n, device=dev, generator=gen) < 0.5
    ids = fp.frontier_pack_cuda(mask, n)[0]
    if not torch.equal(ids.long(), torch.nonzero_static(mask, size=n, fill_value=n)[:, 0]):
        raise AssertionError("frontier_pack and torch.nonzero_static disagree")
    fields, per_field, dim, nbag = 39, 100_000, 10, 16_384
    table = torch.randn(fields * per_field, dim, device=dev, generator=gen)
    idx = (torch.arange(fields, device=dev, dtype=torch.int32) * per_field
           + torch.randint(0, per_field, (nbag, fields), device=dev, generator=gen,
                           dtype=torch.int32))
    idx64 = idx.long()
    calls = {
        "frontier_pack": lambda: fp.frontier_pack_cuda(mask, n),
        "torch.nonzero_static": lambda: torch.nonzero_static(mask, size=n, fill_value=n),
        "torch.nonzero": lambda: torch.nonzero(mask),
        "embedding_bag": lambda: bag.embedding_bag_cuda(table, idx, "sum"),
        "F.embedding_bag": lambda: F.embedding_bag(idx64, table, mode="sum"),
    }
    for what, fn in calls.items():
        graph = "—" if what == "torch.nonzero" else f"{graph_ms(fn):.4f}"   # it syncs
        log(f"[wrappers] tree {root}: {what}: card {graph} ms (CUDA graph), loop "
            f"{cuda_ms(fn, 50, 5, 7):.4f} ms a call, host enqueue {host_us(fn):.1f} us a call")


def load_kernels(root: Path, names=("segment_reduce", "ell_spmv")):
    """The modules `names` of `repro_torch.kernels` under root/src, imported
    afresh (an earlier tree's modules stay alive through the functions
    returned; each tree builds into its own build/kernels)."""
    import importlib

    for name in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    try:
        repro_torch = import_port(root)
        mods = tuple(importlib.import_module(f"repro_torch.kernels.{n}") for n in names)
    finally:
        sys.path[:] = [p for p in sys.path if p != str(root / "src")]
    log(f"[load] tree {root}: {repro_torch.__file__}")
    return mods


def trees_in_turns(root: Path, parent, names):
    """[(label, *modules)] in the order they are timed: parent, change,
    change, parent with --parent, else the change alone."""
    trees = []
    if parent is not None:
        trees.append(("parent", *load_kernels(parent, names)))
    trees.append(("change", *load_kernels(root, names)))     # its modules stay imported
    return trees if parent is None else [trees[0], trees[1], trees[1], trees[0]]


def flash32(dev, root: Path, parent) -> None:
    order = trees_in_turns(root, parent, ("flash_attention",))
    fa = order[1 if parent is not None else 0][1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    cases = {}
    for what, b, sq, skv in (("granite layer", 4, 1024, 1024), ("decode row", 4, 1, 2048)):
        q = torch.randn(b, 32, sq, 128, device=dev, generator=gen)
        k = torch.randn(b, 8, skv, 128, device=dev, generator=gen)
        v = torch.randn(b, 8, skv, 128, device=dev, generator=gen)
        kr, vr = k.repeat(1, 4, 1, 1), v.repeat(1, 4, 1, 1)        # group-major
        cases[what] = (q, k, v, kr, vr, fa.attention_plain(q, k, v, True))
    for label, mod in order:
        for what, (q, k, v, kr, vr, ref) in cases.items():
            got = mod.flash_attention_cuda(q, k, v, True)
            torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
            ms = cuda_ms(lambda: mod.flash_attention_cuda(q, k, v, True), 20, 3, 3)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
                          20, 3, 3)
            log(f"[flash32] {label}: {what}: {ms:.4f} ms, scaled_dot_product_attention "
                f"{lib:.4f} ms, max |kernel - plain| {float((got - ref).abs().max()):.3g}")
    from torch.profiler import ProfilerActivity, profile

    q, k, v, kr, vr, _ = cases["granite layer"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            log(f"[flash32] float32 scaled_dot_product_attention kernel: {e.key}")
    # the change's call, split by kernel: the K/V split pre-pass and the
    # attention kernel (torch.profiler device time)
    for what, (q, k, v, *_) in cases.items():
        for _ in range(3):
            fa.flash_attention_cuda(q, k, v, True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fa.flash_attention_cuda(q, k, v, True)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                log(f"[flash32] change: {what}: {e.key[:60]} {us / 10:.2f} us a call")


def f32_err(got, ref) -> float:
    """max |a - p| over max |p|, worst of dq, dk, dv (BWD_F32_ERR's reading)."""
    return max(float((a.double() - r.double()).abs().max() / r.double().abs().max())
               for a, r in zip(got, ref))


def tree_bwd(mod, q, k, v, out, dout, lse):
    """The tree's backward as it takes it: with the forward's lse where it
    takes one (every route since the TF32 redesign; the wgmma route before)."""
    try:
        return mod.flash_attention_bwd_cuda(q, k, v, out, dout, True, lse)
    except ValueError as e:             # an earlier tree: its CUDA-core route takes no lse
        if "lse" not in str(e):
            raise
        return mod.flash_attention_bwd_cuda(q, k, v, out, dout, True)


def flash_bwd(dev, root: Path, parent) -> None:
    order = trees_in_turns(root, parent, ("flash_attention",))
    fa = order[1 if parent is not None else 0][1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    cases = {}
    for what, (b, hq, hkv, s, d), dt in (
            ("granite-moe layer", (8, 16, 8, 1024, 64), torch.bfloat16),
            ("granite-3-8b layer", (2, 32, 8, 1024, 128), torch.bfloat16),
            ("100m layer float32", (8, 12, 6, 128, 64), torch.float32),
            ("granite-moe layer float32", (8, 16, 8, 1024, 64), torch.float32)):
        q = torch.randn(b, hq, s, d, device=dev, generator=gen).to(dt)
        k, v = (torch.randn(b, hkv, s, d, device=dev, generator=gen).to(dt) for _ in range(2))
        dout = torch.randn(b, hq, s, d, device=dev, generator=gen).to(dt)
        out, lse = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
        plain = fa.attention_bwd_rounded if dt == torch.bfloat16 else fa.attention_bwd_plain
        cases[what] = (q, k, v, dout, out, lse, plain(q, k, v, out, dout))
    for label, mod in order:
        for what, (q, k, v, dout, out, lse, ref) in cases.items():
            kernel = mod.route_bwd(q.dtype, q.shape[-1])
            got = tree_bwd(mod, q, k, v, out, dout, lse)
            if q.dtype == torch.float32:
                err = f32_err(got, ref)
                if not err <= mod.BWD_F32_ERR:
                    raise AssertionError(f"{label} {what}: {err:.3g} from attention_bwd_plain")
                held = f"{err:.3g} from attention_bwd_plain (max |a - p| / max |p|)"
            else:
                err = max(float((a.float() - r.float()).norm() / r.float().norm())
                          for a, r in zip(got, ref))
                held = (f"{err:.3g} from attention_bwd_rounded (relative norm, worst of dq, "
                        "dk, dv)")
            ms = cuda_ms(lambda: tree_bwd(mod, q, k, v, out, dout, lse), 10, 3, 3)
            log(f"[flashbwd] {label}: {what}: {kernel} {ms:.4f} ms, {held}")
    for what, (q, k, v, *_) in cases.items():
        bare = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, True), 20, 3, 3)
        kept = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, True, with_lse=True), 20, 3, 3)
        line = (f"[flashbwd] change: {what}: {fa.route(q.dtype, q.shape[-1])} forward "
                f"{bare:.4f} ms, with lse {kept:.4f} ms")
        if q.dtype == torch.float32:   # beside its bound and the library's forward
            b, hq, s, d = q.shape
            group = hq // k.shape[1]
            kr, vr = k.repeat(1, group, 1, 1), v.repeat(1, group, 1, 1)   # group-major
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
                          20, 3, 3)
            pairs = b * hq * s * (s + 1) // 2          # two products, three TF32 passes
            bnd = bound_ms((2 * q.numel() + 2 * k.numel()) * 4, 3 * 4 * pairs * d,
                           H100.tf32_flops)
            line += (f"; bound {bnd[0]:.4f} ms by {bnd[1]}, float32 "
                     f"scaled_dot_product_attention (kv heads repeated) {lib:.4f} ms")
        log(line)
    from torch.profiler import ProfilerActivity, profile

    for what, (q, k, v, dout, out, lse, _) in cases.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fa.flash_attention_bwd_cuda(q, k, v, out, dout, True, lse)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                log(f"[flashbwd] change: {what}: {e.key[:70]} {us / 10:.2f} us a call")
    bwd_variants(dev, fa, {w: c for w, c in cases.items() if c[0].dtype == torch.float32})


def bwd_variants(dev, fa, cases) -> None:
    """The TF32 backward with each of BWD_VARIANTS' tiles, built in parallel
    into build/probe/, held to `attention_bwd_plain` and timed in two rounds
    at the float32 cases."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for w, st in BWD_VARIANTS:
        lib = out_dir / f"libflash_attention_bwd_w{w}_s{st}.so"
        jobs[(w, st)] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DFLASH_BWD_WARPS={w}",
             f"-DFLASH_BWD_STEP={st}", "-o", str(lib),
             str(_build.CSRC / "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (w, st), (lib, proc) in jobs.items():
        report = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"the w={w} step={st} build failed:\n{report[-3000:]}")
        for k in parse_ptxas(report):
            m = re.search(r"(dkdv_kernel|dq_kernel)IfLi64ELb1E", k.name)
            if m:
                log(f"[flashbwd] variant warps={w} step={st}: {m.group(1)}<float, 64, causal> "
                    f"{k.registers} registers, {k.spill_bytes} spill bytes (stores + loads)")
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd_launch
        fn.argtypes, fn.restype = list(fa._BWD_ARGTYPES), ctypes.c_int
        fns[(w, st)] = fn

    def run(fn, q, k, v, out, dout, lse):
        b, hq, sq, d = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stats = torch.empty(fa.bwd_stats_floats(b, hq, sq), device=dev)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                 b, hq, k.shape[1], sq, k.shape[2], d, 1.0 / d ** 0.5, 1, 0,
                 _build.stream_of(dev))
        _build.check(err, "flash_attention_bwd variant")
        return dq, dk, dv

    for key, fn in fns.items():
        for what, (q, k, v, dout, out, lse, ref) in cases.items():
            err = f32_err(run(fn, q, k, v, out, dout, lse), ref)
            if not err <= fa.BWD_F32_ERR:
                raise AssertionError(f"variant {key} at {what}: {err:.3g} from the plain version")
    for rnd in range(2):
        for (w, st), fn in fns.items():
            times = {}
            for what, (q, k, v, dout, out, lse, _) in cases.items():
                times[what] = cuda_ms(lambda: run(fn, q, k, v, out, dout, lse), 10, 3, 3)
            log(f"[flashbwd] round {rnd}: variant warps={w} step={st}: "
                + ", ".join(f"{what} {ms:.4f} ms" for what, ms in times.items()))


def rmat22_slices(dev):
    """The ELL slices of RMAT scale 22 (edge factor 16, seed 1, undirected)
    and n: the main path's graph."""
    from repro_torch.graph import generators as G
    from repro_torch.graph import pack_ell
    from repro_torch.graph.csr import from_edges

    src, dst, w = G.rmat_edges(22, 16, 0.57, 0.19, 0.19, seed=1)
    g = from_edges(src, dst, 1 << 22, w, directed=False, device=dev)
    del src, dst, w
    pack = pack_ell(g.inc)
    return pack.slices, g.n_nodes


def spmm(dev, root: Path, parent) -> None:
    order = trees_in_turns(root, parent, ("ell_spmv",))
    slices, n = rmat22_slices(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    feats = {}
    for d in (64, 70):
        feats[d] = torch.rand(n + 1, d, device=dev, generator=gen)
        feats[d][n] = 0.0
    csrs = []
    for s in slices:
        live = s.nbr != n
        crow = torch.zeros(s.rows + 1, dtype=torch.int32, device=dev)
        crow[1:] = live.sum(dim=1).cumsum(0)
        csrs.append(torch.sparse_csr_tensor(crow, s.nbr[live], s.wgt[live],
                                            size=(s.rows, n + 1)))
    real = sum(int((s.nbr != n).sum()) for s in slices)
    log(f"[spmm] RMAT 22: n={n}, {real} live slots, slices "
        f"{[tuple(s.nbr.shape) for s in slices]}")
    ref = {}
    for label, ell in order:
        for d, f in feats.items():
            outs = [ell.ell_spmm_cuda(s.nbr, s.wgt, f) for s in slices]
            if d not in ref:
                ref[d] = outs
            for a, b in zip(outs, ref[d]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            del outs
            per = [cuda_ms(lambda s=s: ell.ell_spmm_cuda(s.nbr, s.wgt, f), 10, 2, 3)
                   for s in slices]
            ms = cuda_ms(lambda: [ell.ell_spmm_cuda(s.nbr, s.wgt, f) for s in slices],
                         5, 2, 3)
            lib = cuda_ms(lambda: [torch.sparse.mm(c, f) for c in csrs], 5, 2, 3)
            log(f"[spmm] {label}: D={d}: {ms:.4f} ms (slices {[round(x, 4) for x in per]}), "
                f"torch.sparse.mm {lib:.4f} ms; row requests {real * d * 4 / ms / 1e9:.3f} TB/s")
    ell = order[1 if parent is not None else 0][1]
    uniform = []
    for s in slices:
        live = s.nbr != n
        ids = torch.randint(0, n, s.nbr.shape, device=dev, generator=gen, dtype=torch.int32)
        uniform.append((torch.where(live, ids, n), s.wgt))
    for d, f in feats.items():
        ms = cuda_ms(lambda: [ell.ell_spmm_cuda(nb, wg, f) for nb, wg in uniform], 5, 2, 3)
        log(f"[spmm] change: D={d}, live ids drawn uniformly: {ms:.4f} ms; row requests "
            f"{real * d * 4 / ms / 1e9:.3f} TB/s")


def combine(dev, root: Path, parent) -> None:
    order = trees_in_turns(root, parent, ("segment_reduce", "ell_spmv"))
    from repro_torch.graph import generators as G
    from repro_torch.graph import pack_ell
    from repro_torch.graph.csr import from_edges

    src, dst, w = G.rmat_edges(22, 16, 0.57, 0.19, 0.19, seed=1)
    g = from_edges(src, dst, 1 << 22, w, directed=False, device=dev)
    del src, dst, w
    pack = pack_ell(g.inc)
    n, m = g.n_nodes, g.n_edges
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    sid = torch.sort(g.out.col_idx).values
    sv = torch.rand(m, device=dev, generator=gen)
    live = torch.rand(m, device=dev, generator=gen) < 0.01
    sparse = torch.sort(torch.where(live, g.out.col_idx, n)).values
    vals = torch.rand(n + 1, device=dev, generator=gen) * 64
    parts = [torch.rand(s.rows, device=dev, generator=gen) for s in pack.slices]
    del g
    log(f"[combine] RMAT 22: n={n} m={m}, {int(live.sum())} live lanes in the sparse push, "
        f"slices {[tuple(s.nbr.shape) for s in pack.slices]}")
    ref = {}
    for label, sr, ell in order:
        calls = {"push": lambda: sr.segment_reduce_cuda(sv, sid, n, "sum"),
                 "push 1 %": lambda: sr.segment_reduce_cuda(sv, sparse, n, "sum")}
        for s, p in zip(pack.slices, parts):
            calls[f"merge E={s.rows}"] = (lambda s=s, p=p:
                                          sr.segment_reduce_cuda(p, s.row_id, n + 1, "sum"))
        for s in pack.slices:
            calls[f"ell {tuple(s.nbr.shape)}"] = (lambda s=s:
                                                  ell.ell_combine_cuda(s.nbr, s.wgt, vals,
                                                                       "add_w", "min"))
        for what, fn in calls.items():
            got = fn()
            if what not in ref:
                ref[what] = got
            elif what.startswith("ell"):
                if not torch.equal(got.view(torch.int32), ref[what].view(torch.int32)):
                    raise AssertionError(f"{label}: {what} differs between the trees")
            else:
                torch.testing.assert_close(got, ref[what], rtol=1e-5, atol=1e-6)
            ms = graph_ms(fn) if what.startswith("merge") else cuda_ms(fn, 20, 3, 3)
            log(f"[combine] {label}: {what}: {ms:.4f} ms")
    # the change's push call, split by kernel (torch.profiler device time)
    from torch.profiler import ProfilerActivity, profile

    sr = order[1 if parent is not None else 0][1]
    for what, ids in (("push", sid), ("push 1 %", sparse)):
        for _ in range(3):
            sr.segment_reduce_cuda(sv, ids, n, "sum")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                sr.segment_reduce_cuda(sv, ids, n, "sum")
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                log(f"[combine] change: {what}: {e.key[:60]} {us / 10:.2f} us a call")


def candidate_layouts(ell, q: int, w: int) -> list:
    """Every layout `ell_combine_batched`'s kernel takes at Q and width W,
    16-byte columns where Q % 4 == 0: slot lanes with L lanes a row (p / 8 <=
    L <= min(p, 32)), and column lanes with G lanes over the columns (as
    `batched_layout` sets them for wide Q) and S slot groups (S <= p,
    G S <= 32)."""
    vec = q % 4 == 0
    p = 1 << max(w - 1, 0).bit_length()
    out = [ell.BatchedLayout("slots", vec, 1, lanes) for lanes in (1, 2, 4, 8, 16, 32)
           if max(p // 8, 1) <= lanes <= min(p, 32)]
    cols = min(32, 1 << max(-(-q // (4 if vec else 1)) - 1, 0).bit_length())
    out += [ell.BatchedLayout("columns", vec, cols, groups) for groups in (1, 2, 4, 8, 16, 32)
            if groups <= min(32 // cols, p)]
    return out


def batched(dev, root: Path, parent) -> None:
    order = trees_in_turns(root, parent, ("ell_spmv",))
    slices, n = rmat22_slices(dev)
    real = sum(int((s.nbr != n).sum()) for s in slices)
    log(f"[batched] RMAT 22: n={n}, {real} real slots, slices "
        f"{[tuple(s.nbr.shape) for s in slices]}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    vals = {q: torch.rand(n + 1, q, device=dev, generator=gen) * 64 for q in (4, 8, 16, 32, 64)}
    ref = {}
    for label, ell in order:
        for q in (8, 64):
            for op, comb in (("copy", "sum"), ("add_w", "min")):
                v = vals[q]
                for i, s in enumerate(slices):
                    got = ell.ell_combine_batched_cuda(s.nbr, s.wgt, v, op, comb)
                    key = (q, op, i)
                    if key not in ref:
                        ref[key] = got
                    elif not torch.equal(got.view(torch.int32), ref[key].view(torch.int32)):
                        raise AssertionError(f"{label}: Q={q} {op}/{comb} slice {i} differs "
                                             "between the trees")
                per = [cuda_ms(lambda s=s: ell.ell_combine_batched_cuda(s.nbr, s.wgt, v, op,
                                                                        comb), 10, 2, 3)
                       for s in slices]
                log(f"[batched] {label}: Q={q} {op}/{comb}: {sum(per):.4f} ms (slices "
                    f"{[round(x, 4) for x in per]})")
    ref.clear()
    ell = order[1 if parent is not None else 0][1]
    for q, v in vals.items():
        best = 0.0
        for s in slices:
            want = ell.ell_combine_batched_plain(s.nbr, s.wgt, v, "copy", "sum")
            picked = ell.batched_layout(q, s.width, v.data_ptr(), 0)
            times = {}
            for lay in candidate_layouts(ell, q, s.width):
                got = ell._launch_batched(s.nbr, s.wgt, v, "copy", "sum", lay)
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise AssertionError(f"{lay} Q={q} differs from the plain version on the "
                                         f"{tuple(s.nbr.shape)} slice")
                del got
                times[lay] = cuda_ms(lambda lay=lay: ell._launch_batched(
                    s.nbr, s.wgt, v, "copy", "sum", lay), 10, 2, 3)
            del want
            best += min(times.values())
            log(f"[batched] change: Q={q} slice {tuple(s.nbr.shape)} copy/sum by layout: "
                + ", ".join(f"{lay.route} {lay.column_lanes}x{lay.slot_groups}"
                            f"{' (picked)' if lay == picked else ''} {t:.4f} ms"
                            for lay, t in times.items()))
        log(f"[batched] change: Q={q} copy/sum, four slices at their fastest layouts: "
            f"{best:.4f} ms")
    uniform = []
    for s in slices:
        live = s.nbr != n
        ids = torch.randint(0, n, s.nbr.shape, device=dev, generator=gen, dtype=torch.int32)
        uniform.append((torch.where(live, ids, n), s.wgt))
    for q in (8, 64):
        v = vals[q]
        real_ms = cuda_ms(lambda: [ell.ell_combine_batched_cuda(s.nbr, s.wgt, v, "copy", "sum")
                                   for s in slices], 5, 2, 3)
        uni_ms = cuda_ms(lambda: [ell.ell_combine_batched_cuda(nb, wg, v, "copy", "sum")
                                  for nb, wg in uniform], 5, 2, 3)
        log(f"[batched] change: Q={q} copy/sum, real ids {real_ms:.4f} ms, live ids drawn "
            f"uniformly {uni_ms:.4f} ms; gather requests {real * q * 4 / real_ms / 1e9:.3f} "
            f"and {real * q * 4 / uni_ms / 1e9:.3f} TB/s")


EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_kernel(dev):
    """A launcher of an empty kernel, built by nvcc into build/probe/:
    `launch(blocks, threads)` on PyTorch's current stream."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "empty.cu", out / "libempty.so"
    src.write_text(EMPTY_SOURCE)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"the empty kernel did not build:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lambda blocks, threads: _build.check(fn(blocks, threads, _build.stream_of(dev)),
                                                "empty kernel")


COLD_WINDOWS = 64       # calls a cold replay cycles through (distinct bags)
COLD_SETS = 8           # draws of the largest batch behind the cold windows


def deepfm_ids(dev, gen, bags: int):
    """(bags, 39) int32 ids, one a field of DeepFM's 39 x 100,000 table."""
    fields, per_field = 39, 100_000
    return (torch.arange(fields, device=dev, dtype=torch.int32) * per_field
            + torch.randint(0, per_field, (bags, fields), device=dev, generator=gen,
                            dtype=torch.int32))


def cold_ms(fn, ids, nb: int) -> float:
    """graph_ms of `fn(window)` over up to COLD_WINDOWS windows of `nb` bags
    from `ids`, one a call in turn: each call's rows were last read at least
    ~80 MB of other rows ago, so L2 holds little of them, as for a server's
    next batch (the same window every call would find its rows in L2)."""
    windows = [ids[w * nb:(w + 1) * nb] for w in range(min(COLD_WINDOWS, ids.shape[0] // nb))]
    turn = iter(range(1 << 30))
    return graph_ms(lambda: fn(windows[next(turn) % len(windows)]), per=COLD_WINDOWS)


def bag_probe(dev, root: Path, parent) -> None:
    order = trees_in_turns(root, parent, ("embedding_bag",))
    empty = empty_kernel(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    table = torch.randn(39 * 100_000, 10, device=dev, generator=gen)
    many = deepfm_ids(dev, gen, COLD_SETS * max(BAG_BATCHES))
    many64 = many.long()
    idx, idx64 = many[:max(BAG_BATCHES)], many64[:max(BAG_BATCHES)]
    # the change's grid at B = 512: one warp a bag, 4 warps a block
    small_grid = -(-512 * 32 // 128)
    ref = {}
    for label, mod in order:
        floor = (graph_ms(lambda: empty(1, 128)), graph_ms(lambda: empty(small_grid, 128)))
        log(f"[bag] {label}: empty kernel {floor[0]:.4f} ms (1 block), {floor[1]:.4f} ms "
            f"({small_grid} blocks of 128)")
        for nb in BAG_BATCHES:
            ids, ids64 = idx[:nb], idx64[:nb]
            for mode in ("sum", "mean"):
                got = mod.embedding_bag_cuda(table, ids, mode)
                if (nb, mode) not in ref:
                    ref[(nb, mode)] = got
                torch.testing.assert_close(got, ref[(nb, mode)], rtol=1e-5, atol=1e-5)
                if label == "change" and not torch.equal(
                        got.view(torch.int32),
                        mod.embedding_bag_ordered(table, ids, mode).view(torch.int32)):
                    raise AssertionError(f"B={nb} {mode}: not bit-equal to "
                                         "embedding_bag_ordered")
                ms = graph_ms(lambda: mod.embedding_bag_cuda(table, ids, mode))
                lib = graph_ms(lambda: F.embedding_bag(ids64, table, mode=mode))
                log(f"[bag] {label}: B={nb} {mode}: {ms:.4f} ms, F.embedding_bag {lib:.4f} ms")
            cold = cold_ms(lambda w: mod.embedding_bag_cuda(table, w, "sum"), many, nb)
            lib = cold_ms(lambda w: F.embedding_bag(w, table, mode="sum"), many64, nb)
            log(f"[bag] {label}: B={nb} sum, a new window of bags each call: {cold:.4f} ms, "
                f"F.embedding_bag {lib:.4f} ms")


#: the shipped lines of csrc/embedding_bag.cu that `bagvar` rewrites in a
#: copy, and what each variant writes in their place
BAG_KNOBS = {
    "loads": "constexpr int LOADS = 8;",
    "threads": "constexpr int THREADS = 128;",
    "bounds": "__launch_bounds__(THREADS)\n",
    "groups": "const int groups = WARP / lanes < K ? WARP / lanes : K;",
}
#: (name, {knob: replacement}, row groups cap); the first is the source as
#: is; the caps assume K >= 3, as DeepFM's 39
BAG_VARIANTS = [
    ("as is", {}, None),
    ("4 loads a lane", {"loads": "constexpr int LOADS = 4;"}, None),
    ("16 loads a lane", {"loads": "constexpr int LOADS = 16;"}, None),
    ("32 registers", {"bounds": "__launch_bounds__(THREADS, 16)\n"}, None),
    ("256 threads", {"threads": "constexpr int THREADS = 256;"}, None),
    ("3 groups (2 bags a warp)",
     {"groups": "const int groups = WARP / lanes < 3 ? WARP / lanes : 3;"}, 3),
    ("2 groups (3 bags a warp)",
     {"groups": "const int groups = WARP / lanes < 2 ? WARP / lanes : 2;"}, 2),
    ("1 group (6 bags a warp)", {"groups": "const int groups = 1;"}, 1),
    ("1 group, 4 loads a lane", {"groups": "const int groups = 1;",
                                 "loads": "constexpr int LOADS = 4;"}, 1),
]


def bag_variant_source(out: Path, k: int, changes: dict) -> Path:
    """A copy of csrc/embedding_bag.cu under `out` with the knob lines
    replaced; each shipped line must appear exactly once."""
    from repro_torch.kernels import _build

    text = (_build.CSRC / "embedding_bag.cu").read_text()
    for knob, new in changes.items():
        if text.count(BAG_KNOBS[knob]) != 1:
            raise RuntimeError(f"bagvar: {BAG_KNOBS[knob]!r} is not once in embedding_bag.cu")
        text = text.replace(BAG_KNOBS[knob], new)
    path = out / f"embedding_bag_v{k}.cu"
    path.write_text(text)
    return path


def bag_variants(dev, parent) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as bag

    out = _build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = [(name, bag_variant_source(out, k, changes), cap)
               for k, (name, changes, cap) in enumerate(BAG_VARIANTS)]
    if parent is not None:
        sources.append(("parent", parent / "src/repro_torch/csrc/embedding_bag.cu", None))
    caps = {name: cap for name, _, cap in sources}
    jobs = {}
    for k, (name, src, _) in enumerate(sources):
        lib = out / f"libembedding_bag_v{k}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        report = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{report[-3000:]}")
        regs = [k.registers for k in parse_ptxas(report) if "bag_kernelILi0ELi2ELi1E" in k.name]
        log(f"[bagvar] {name}: sum, 8-byte loads, one load a row: registers {regs}")
        fn = ctypes.CDLL(str(lib)).embedding_bag_launch
        fn.argtypes = list(bag._ARGTYPES)
        fn.restype = ctypes.c_int
        fns[name] = fn

    def run(fn, table, ids, mode="sum"):
        o = torch.empty(ids.shape[0], table.shape[1], device=dev)
        _build.check(fn(table.data_ptr(), ids.data_ptr(), o.data_ptr(), ids.shape[0],
                        ids.shape[1], table.shape[1], table.shape[0], bag.MODES[mode],
                        _build.stream_of(dev)), "variant")
        return o

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    table = torch.randn(39 * 100_000, 10, device=dev, generator=gen)
    many = deepfm_ids(dev, gen, COLD_SETS * max(BAG_BATCHES))
    idx = many[:max(BAG_BATCHES)]
    for name, fn in fns.items():
        for nb in BAG_BATCHES:
            for mode in ("sum", "mean"):
                a = run(fn, table, idx[:nb], mode)
                groups = bag.bag_layout(table.shape[1], idx.shape[1], table.data_ptr())[2]
                o = bag.embedding_bag_ordered(table, idx[:nb], mode,
                                              min(groups, caps[name] or groups))
                if name != "parent" and not torch.equal(a.view(torch.int32), o.view(torch.int32)):
                    raise AssertionError(f"variant {name} B={nb} {mode} differs")
                torch.testing.assert_close(a, o, rtol=1e-5, atol=1e-5)
    # the same batches with ids in the first 12,500 rows of each field: 19.5
    # MB of rows, which L2 holds; a time far below the full table's says
    # device memory, not the L2's request rate, sets the full table's time
    near = (torch.arange(39, device=dev, dtype=torch.int32) * 100_000
            + torch.randint(0, 12_500, (max(BAG_BATCHES), 39), device=dev, generator=gen,
                            dtype=torch.int32))
    for name, fn in fns.items():
        log(f"[bagvar] {name}: ids in 19.5 MB of rows, same bags each call "
            f"{[round(graph_ms(lambda: run(fn, table, near[:nb])), 4) for nb in BAG_BATCHES]} ms")
    for rnd in range(2):
        for name, fn in fns.items():
            warm = [graph_ms(lambda: run(fn, table, idx[:nb])) for nb in BAG_BATCHES]
            cold = [cold_ms(lambda w: run(fn, table, w), many, nb) for nb in BAG_BATCHES]
            log(f"[bagvar] round {rnd}: {name}: same bags each call "
                f"{[round(x, 4) for x in warm]} ms, new bags each call "
                f"{[round(x, 4) for x in cold]} ms (B = {list(BAG_BATCHES)})")


#: (thread-tier limit, sub-tiles a chunk); the first ships
TIER_VARIANTS = [(8, 4), (4, 4), (16, 4), (8, 8), (8, 2)]


def tiers(dev) -> None:
    from repro_torch.graph import generators as G
    from repro_torch.graph import pack_ell
    from repro_torch.graph.csr import from_edges
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_reduce as sr

    out = _build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for t, u in TIER_VARIANTS:
        lib = out / f"libsegment_reduce_t{t}_u{u}.so"
        jobs[(t, u)] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DSEG_THREAD_SEG={t}", f"-DSEG_UNROLL={u}",
             "-o", str(lib), str(_build.CSRC / "segment_reduce.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (lib, proc) in jobs.items():
        report = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key} failed to build:\n{report[-3000:]}")
        regs = [k.registers for k in parse_ptxas(report)]
        log(f"[tiers] thread limit {key[0]}, {key[1]} sub-tiles: registers {sorted(set(regs))}")
        fn = ctypes.CDLL(str(lib)).segment_reduce_launch
        fn.argtypes = list(sr._ARGTYPES)
        fn.restype = ctypes.c_int
        fns[key] = fn

    def run(fn, vals, ids, num, combine):
        e = vals.shape[0]
        o = torch.empty(num, device=dev)
        lst = torch.empty(e // (sr.LONG_SEG + 1) + 1, dtype=torch.int32, device=dev)
        st = torch.empty(3, dtype=torch.int32, device=dev)
        _build.check(fn(vals.data_ptr(), ids.data_ptr(), e, 1, num,
                        sr.COMBINE_OPS[combine], sr.identity(combine), o.data_ptr(),
                        lst.data_ptr(), st.data_ptr(), _build.stream_of(dev)), "variant")
        return o

    src, dst, w = G.rmat_edges(22, 16, 0.57, 0.19, 0.19, seed=1)
    g = from_edges(src, dst, 1 << 22, w, directed=False, device=dev)
    del src, dst, w
    pack = pack_ell(g.inc)
    n, m = g.n_nodes, g.n_edges
    sid = torch.sort(g.out.col_idx).values
    del g
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    sv = torch.rand(m, device=dev, generator=gen)
    big = max(pack.slices, key=lambda s: s.rows)
    part = torch.rand(big.rows, device=dev, generator=gen)
    shipped = sr.THREAD_SEG
    for (t, u), fn in fns.items():
        sr.THREAD_SEG = t                        # the model's tier limit
        try:
            for vals, ids, num in ((sv, sid, n), (part, big.row_id, n + 1)):
                for combine in ("sum", "min"):
                    a = run(fn, vals, ids, num, combine)
                    o = sr.segment_reduce_ordered(vals, ids, num, combine)
                    if not torch.equal(a.view(torch.int32), o.view(torch.int32)):
                        raise AssertionError(f"variant {(t, u)} {combine} differs from "
                                             "segment_reduce_ordered")
        finally:
            sr.THREAD_SEG = shipped
    for rnd in range(2):
        for (t, u), fn in fns.items():
            push = cuda_ms(lambda: run(fn, sv, sid, n, "sum"), 20, 3, 3)
            merge = graph_ms(lambda: run(fn, part, big.row_id, n + 1, "sum"))
            log(f"[tiers] round {rnd}: thread limit {t}, {u} sub-tiles: push {push:.4f} ms, "
                f"merge E={big.rows} {merge:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("tiles", "pack", "wrappers", "combine", "tiers",
                                      "flash32", "spmm", "bag", "bagvar", "batched",
                                      "flashbwd"))
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch the wrappers and combine probes time")
    ap.add_argument("--parent", type=Path, default=None,
                    help="combine, flash32, spmm, bag, batched, flashbwd: also time the "
                         "tree under this checkout, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_kernel_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    log(f"[card] {card_line()}")
    if args.probe in ("combine", "flash32", "spmm", "bag", "batched", "flashbwd"):
        {"combine": combine, "flash32": flash32, "spmm": spmm, "bag": bag_probe,
         "batched": batched, "flashbwd": flash_bwd}[args.probe](dev, args.root, args.parent)
        return 0
    import_port(args.root if args.probe == "wrappers" else ROOT)
    if args.probe == "bagvar":
        bag_variants(dev, args.parent)
    elif args.probe == "tiles":
        flash_tiles(dev)
    elif args.probe == "tiers":
        tiers(dev)
    elif args.probe == "pack":
        pack_breakdown(dev)
    else:
        wrappers(dev, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
