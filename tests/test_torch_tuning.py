"""`repro_torch.kernels.tuning`: the paper's Eq. 1 on Hopper, the ptxas
report's parse and the H100's constants, on the CPU.

`resident_blocks` is checked on cases worked by hand from the Hopper limits
(registers to a warp in units of 256 from four sub-partitions of 16,384,
shared memory plus the 1 KiB reserved a block in units of 128 against
228 KiB, 64 warps and 32 blocks an SM); the smoke's phase 16 (a) holds it
to CUDA's occupancy on the card for every launched instance. The parse
reads a report nvcc wrote for `csrc/flash_attention_bwd_wgmma.cu` and two
spilling `ell_combine_batched` instances (tests/data/ptxas_report.log)."""

import ast
from pathlib import Path

import pytest

from repro_torch.kernels import tuning
from repro_torch.kernels.tuning import H100, co_resident_grid, parse_ptxas, resident_blocks

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("threads,regs,static,dyn,want", [
    (256, 32, 0, 0, 8),          # 1,024 registers a warp: 16 warps a sub-partition, 64 an SM
    (256, 37, 0, 0, 6),          # 1,184 -> 1,280 a warp: 12 a sub-partition, 48 warps
    (256, 44, 0, 0, 5),          # 1,408 -> 1,536: 10 a sub-partition, 40 warps
    (186, 48, 0, 49104, 4),      # 6 warps; 50,128 -> 50,176 B a block: 4 in 228 KiB
    (128, 24, 0, 0, 16),         # 4 warps a block, the warp limit
    (32, 16, 0, 0, 32),          # one warp a block, the block limit
    (384, 168, 1024, 210944, 1),  # the wgmma backward's dK/dV: 1 block of 3 warpgroups
    (256, 255, 0, 0, 1),         # 8,160 -> 8,192 a warp: 2 a sub-partition, 8 warps
    (1024, 64, 0, 0, 1),         # 2,048 a warp x 32 warps: the whole register file
    (1024, 65, 0, 0, 0),         # 2,304 a warp x 32 warps > 65,536 a block
    (256, 256, 0, 0, 0),         # above 255 registers a thread
    (256, 16, 0, H100.smem_per_block + 1, 0),   # above 227 KiB a block
    (2048, 16, 0, 0, 0),         # above 1,024 threads a block
    (256, 0, 0, 115 * 1024, 1),  # 116 KiB a block: one fits in 228 KiB
    (256, 0, 0, 112 * 1024, 2),  # 113 KiB a block: two fit
])
def test_resident_blocks_hand_worked(threads, regs, static, dyn, want):
    assert resident_blocks(threads, regs, static, dyn) == want
    assert co_resident_grid(threads, regs, static, dyn) == want * H100.sm_count


def test_register_limit_rounds_per_sub_partition():
    """6 warps of 48 registers: 40 warps fit the register file as a whole,
    but each sub-partition holds 10, so 6 whole blocks (36 warps), not 6.67."""
    assert resident_blocks(192, 48) == 6
    assert resident_blocks(192, 48, dyn_smem=40 * 1024) == 5     # 41 KiB a block


def test_parse_ptxas_report():
    report = (ROOT / "tests" / "data" / "ptxas_report.log").read_text()
    found = parse_ptxas(report)
    assert len(found) == 11 == report.count("Compiling entry function")
    first = found[0]
    assert "dq_kernelILi128ELb0E" in first.name
    assert (first.registers, first.spill_bytes, first.static_smem) == (156, 0, 1024)
    dkdv = [k for k in found if "dkdv_kernel" in k.name]
    assert dkdv and all(k.registers == 168 for k in dkdv)     # setmaxnreg's entry count
    spilled = found[-2:]
    assert [k.spill_bytes for k in spilled] == [112 + 160, 96 + 144]
    assert all((k.registers, k.static_smem) == (64, 0) for k in spilled)


def test_kernel_resources_empty_before_a_build(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert tuning.kernel_resources("segment_reduce") == []


def test_h100_constants():
    """The data-sheet rates every bound uses, and the SM's limits."""
    assert (H100.bf16_flops, H100.tf32_flops, H100.f32_flops) == (989e12, 495e12, 67e12)
    assert (H100.hbm_bw, H100.nvlink_bw) == (3.35e12, 450e9)
    assert (H100.sm_count, H100.hbm_bytes) == (132, 80 * 1024 ** 3)
    assert H100.regs_per_sm == H100.sub_partitions * 16384
    assert H100.smem_per_sm == 228 * 1024 and H100.smem_per_block == 227 * 1024


def test_the_smoke_and_the_probe_take_the_constants_from_tuning():
    """No copy of the rates or of the ptxas parse outside `tuning`."""
    smoke = (ROOT / "chip_smoke.py").read_text()
    for literal in ("3.35e12", "989e12", "495e12", "67e12", "def ptxas_instances"):
        assert literal not in smoke, literal
    assert "from repro_torch.kernels.tuning import H100" in smoke
    for script in sorted((ROOT / "scripts").glob("port_*.py")):
        text = script.read_text()
        for literal in ("3.35e12", "989e12", "495e12", "67e12", "Used (\\d+) registers"):
            assert literal not in text, (script.name, literal)
        ast.parse(text)
