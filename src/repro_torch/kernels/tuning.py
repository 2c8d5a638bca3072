"""The H100's rates and limits, and the paper's Eq. 1 on the GPU it was
written for.

Counterpart of `repro.kernels.tuning`. The reference sizes Pallas tiles from
a VMEM budget, the TPU's analogue of SIMD-X's Eq. 1. Eq. 1 itself is the
GPU's: the number of blocks (CTAs) of one kernel that a streaming
multiprocessor keeps resident at once, from the registers and shared memory
the compiler reports. A grid of that many blocks per SM is one whose blocks
all run at the same time, so they can wait at a global barrier without
deadlock (the paper's persistent kernel). `resident_blocks` computes it for
Hopper (compute capability 9.0) with the hardware's allocation
granularities; `co_resident_grid` multiplies by the SMs.
`kernel_resources` reads each compiled instance's registers, spills and
static shared memory from nvcc's `-Xptxas -v` report (`_build.ptxas_report`).
`chip_smoke.py` holds `resident_blocks` to CUDA's own
`cudaOccupancyMaxActiveBlocksPerMultiprocessor` for every instance it
launches.

The reference's tile choosers (`ell_tile_rows`, `spmm_tile_rows`,
`attn_block_sizes`) have no counterpart: each `.cu` fixes its tiles at
compile time, e.g. `csrc/flash_attention.cu` BQ 128 and BKV 32 (8 warps),
`csrc/segment_reduce.cu` THREADS 256, SEG_THREAD_SEG 8, LONG_SEG 2048,
`csrc/ell_combine.cu` and `csrc/ell_spmm.cu` THREADS 256, and
`csrc/embedding_bag.cu` THREADS 128, LOADS 8.

`H100` holds the H100 SXM's data-sheet rates, the ones every bound of
`chip_smoke.py` and `scripts/port_*.py` uses: dense bf16 989 TFLOP/s, dense
TF32 495 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35
TB/s, NVLink 450 GB/s each way; 132 SMs and 80 GiB, which the smoke reads
back from the card.
"""

from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple


@dataclasses.dataclass(frozen=True)
class H100Spec:
    """One H100 SXM (compute capability 9.0) at its 700 W limit."""

    bf16_flops: float = 989e12       # dense bf16 on the tensor cores, FLOP/s
    tf32_flops: float = 495e12       # dense TF32 on the tensor cores
    f32_flops: float = 67e12         # float32 on the CUDA cores
    hbm_bw: float = 3.35e12          # HBM3, bytes/s
    nvlink_bw: float = 450e9         # NVLink 4, bytes/s each way
    hbm_bytes: int = 80 * 1024 ** 3
    sm_count: int = 132
    # per SM and per block (CUDA programming guide, compute capability 9.0)
    regs_per_sm: int = 65536
    regs_per_block: int = 65536
    max_regs_per_thread: int = 255
    reg_unit: int = 256              # registers go to a warp in units of 256
    sub_partitions: int = 4          # each holds a quarter of the register file
    smem_per_sm: int = 233472        # 228 KiB
    smem_per_block: int = 232448     # 227 KiB, with the opt-in attribute
    smem_reserved: int = 1024        # the system's share of every block
    smem_unit: int = 128
    threads_per_block: int = 1024
    warps_per_sm: int = 64
    blocks_per_sm: int = 32
    warp: int = 32


H100 = H100Spec()


def round_up(x: int, to: int) -> int:
    return ((x + to - 1) // to) * to


def resident_blocks(threads: int, regs_per_thread: int, static_smem: int = 0,
                    dyn_smem: int = 0) -> int:
    """Eq. 1 on Hopper: blocks of `threads` threads, each thread holding
    `regs_per_thread` registers and each block `static_smem` +
    `dyn_smem` bytes of shared memory, that one SM keeps resident at once
    (0: the block does not fit). The least of

      * registers: a warp takes regs * 32 rounded up to 256; each of the
        four sub-partitions holds 16,384 of them, so an SM holds
        floor(16,384 / per warp) * 4 warps;
      * shared memory: static + dynamic + the 1 KiB reserved a block,
        rounded up to 128 bytes, against 228 KiB;
      * warps (64 an SM) and blocks (32 an SM)."""
    warps = -(-threads // H100.warp)
    if not 0 < threads <= H100.threads_per_block or regs_per_thread > H100.max_regs_per_thread:
        return 0
    by_regs = H100.blocks_per_sm
    if regs_per_thread > 0:
        per_warp = round_up(regs_per_thread * H100.warp, H100.reg_unit)
        # the launch check assumes every sub-partition takes a share of the warps
        if (per_warp * round_up(warps, H100.sub_partitions) > H100.regs_per_block
                or per_warp * warps > H100.regs_per_block):
            return 0
        per_part = H100.regs_per_sm // H100.sub_partitions
        by_regs = (per_part // per_warp) * H100.sub_partitions // warps
    smem = round_up(static_smem + dyn_smem + H100.smem_reserved, H100.smem_unit)
    if static_smem + dyn_smem > H100.smem_per_block:
        return 0
    by_smem = H100.smem_per_sm // smem
    return min(by_regs, by_smem, H100.warps_per_sm // warps, H100.blocks_per_sm)


def co_resident_grid(threads: int, regs_per_thread: int, static_smem: int = 0,
                     dyn_smem: int = 0) -> int:
    """The largest grid whose blocks are all resident at once: Eq. 1 times
    the SMs (the grid a global barrier may wait on without deadlock)."""
    return resident_blocks(threads, regs_per_thread, static_smem, dyn_smem) * H100.sm_count


#: bytes `launched_instances` gives a mangled name
NAME_BYTES = 1024


class KernelResources(NamedTuple):
    """One compiled kernel instance, as ptxas reports it."""

    name: str            # mangled entry name
    registers: int
    spill_bytes: int     # spill stores + spill loads
    static_smem: int     # bytes of static shared memory


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(report: str) -> list[KernelResources]:
    """Every entry function of an `-Xptxas -v` report, in report order."""
    out, name, spill = [], None, 0
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = _FRAME.search(line)
        if m and name is not None:
            spill = int(m.group(2)) + int(m.group(3))
            continue
        m = _USED.search(line)
        if m and name is not None:
            s = _SMEM.search(line)
            out.append(KernelResources(name, int(m.group(1)), spill,
                                       int(s.group(1)) if s else 0))
            name = None
    return out


def kernel_resources(source: str) -> list[KernelResources]:
    """The instances of `csrc/<source>.cu` as its last build reported them
    (empty before the first build)."""
    from repro_torch.kernels import _build

    return parse_ptxas(_build.ptxas_report(source))


def launched_instances(source: str) -> list[dict]:
    """The kernel instances `csrc/<source>.cu` has launched in this process
    (each first launch of an instance at a block size and dynamic shared
    memory, `csrc/occupancy.cuh`), with what CUDA reports of each: `name`
    (the mangled name, cudaFuncGetName), `threads`, `dyn_smem`,
    `registers`, `static_smem`, `local_bytes`, `cuda_blocks`
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), `max_threads` and
    `cuda_error` (of those queries; 0 when they ran). Needs the card."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.entry(source, f"{source}_occupancy",
                      (ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_char_p,
                       ctypes.c_int))
    out = (ctypes.c_longlong * 8)()
    name = ctypes.create_string_buffer(NAME_BYTES)
    keys = ("threads", "dyn_smem", "registers", "static_smem", "local_bytes", "cuda_blocks",
            "max_threads", "cuda_error")
    rows, i = [], 0
    while i < fn(i, out, name, NAME_BYTES):
        rows.append(dict(zip(keys, (int(x) for x in out)), name=name.value.decode()))
        i += 1
    return rows


def eq1_rows(source: str) -> list[dict]:
    """Each launched instance of `source` with Eq. 1 beside CUDA's count:
    the ptxas entry of the same mangled name (`ptxas`, None where the
    report has none; its registers, static shared memory and spills),
    `eq1` = `resident_blocks` from ptxas's numbers at the launch's block
    size and dynamic shared memory, and `grid` = `co_resident_grid`.
    Needs the card."""
    compiled = {k.name: k for k in kernel_resources(source)}
    rows = []
    for row in launched_instances(source):
        k = compiled.get(row["name"])
        if k is None:
            rows.append(dict(row, source=source, ptxas=None, spill_bytes=None, eq1=None,
                             grid=None))
            continue
        rows.append(dict(row, source=source, ptxas=k.name, ptxas_registers=k.registers,
                         ptxas_static_smem=k.static_smem, spill_bytes=k.spill_bytes,
                         eq1=resident_blocks(row["threads"], k.registers, k.static_smem,
                                             row["dyn_smem"]),
                         grid=co_resident_grid(row["threads"], k.registers, k.static_smem,
                                               row["dyn_smem"])))
    return rows
