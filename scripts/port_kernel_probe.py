#!/usr/bin/env python3
"""Design probes for the port's CUDA kernels, on one NVIDIA GPU.

    python3 scripts/port_kernel_probe.py tiles
    python3 scripts/port_kernel_probe.py pack
    python3 scripts/port_kernel_probe.py wrappers [--root DIR]

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
from chip_smoke import card_line, cuda_ms, graph_ms, host_us  # noqa: E402

#: the probe entry's C parameters: flash_attention_wgmma_launch's, with the
#: kv-tile width and the ring depth before the stream
PROBE_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
VARIANTS = [(64, 2), (64, 3), (128, 2), (128, 3)]     # (BKV, STAGES); (64, 2) ships


def log(msg: str) -> None:
    print(msg, flush=True)


def import_port(root: Path):
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
    for dp, bkv, stages, causal, regs in re.findall(
            r"Function properties for \S*flash_wgmmaILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E\S*"
            r"[\s\S]*?Used (\d+) registers", report):
        log(f"[tiles] ptxas: D panel {dp}, bkv={bkv} stages={stages} causal={causal}: "
            f"{regs} registers")
    fn = ctypes.CDLL(str(lib)).flash_attention_wgmma_probe
    fn.argtypes = list(PROBE_ARGTYPES)
    fn.restype = ctypes.c_int

    def run(bkv, stages, q, k, v, causal=True):
        b, hq, sq, d = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, k.shape[1],
                 sq, k.shape[2], d, 1.0 / d ** 0.5, int(causal), bkv, stages,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("tiles", "pack", "wrappers"))
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch the wrappers probe times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_kernel_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import_port(args.root if args.probe == "wrappers" else ROOT)
    dev = torch.device("cuda")
    log(f"[card] {card_line()}")
    if args.probe == "tiles":
        flash_tiles(dev)
    elif args.probe == "pack":
        pack_breakdown(dev)
    else:
        wrappers(dev, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
