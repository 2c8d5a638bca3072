"""The kernel library's wiring, on the CPU: which flash kernel a call takes
on the card, the registry of kernels and their launch counters, and the
ctypes argument tuples against the C entry points they call."""

import ctypes
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ell_spmv as tell
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import frontier_pack as tfp
from repro_torch.kernels import segment_reduce as tsr


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 8, "flash_attention"), (torch.bfloat16, 24, "flash_attention"),
    (torch.bfloat16, 64, "flash_attention"), (torch.bfloat16, 128, "flash_attention"),
    (torch.bfloat16, 12, "flash_attention_f32"), (torch.bfloat16, 70, "flash_attention_f32"),
    (torch.float32, 8, "flash_attention_f32"), (torch.float32, 64, "flash_attention_f32"),
    (torch.float32, 128, "flash_attention_f32"), (torch.float32, 12, "flash_attention_f32")])
def test_flash_route_is_a_function_of_dtype_and_head_dim(dtype, d, kernel):
    """bfloat16 with D % 8 == 0 goes to wgmma (fed by TMA, which needs
    16-byte row strides); float32 and other bfloat16 widths go to the TF32
    mma.sync kernel."""
    assert tfa.route(dtype, d) == kernel


@pytest.mark.parametrize("d,dp", [(1, 16), (12, 16), (16, 16), (17, 32), (64, 64), (70, 96),
                                  (96, 96), (97, 128), (128, 128)])
def test_tf32_scratch_holds_the_split_planes(d, dp):
    """The TF32 kernel pads D to 16, 32, 64, 96 or 128 and reads K as 2 DP
    floats a kv row and V as 4 DP floats a pair of kv rows (an odd Skv pads
    its last pair), the room the C entry checks."""
    assert tfa.tf32_padded_dim(d) == dp
    assert tfa.tf32_scratch_floats(2, 3, 7, d) == 2 * 3 * (7 * 2 * dp + 4 * 4 * dp)


def test_both_flash_kernels_and_frontier_pack_are_registered():
    assert _build.KERNELS["flash_attention"] == "flash_attention_wgmma"
    assert _build.KERNELS["flash_attention_f32"] == "flash_attention"
    assert _build.KERNELS["frontier_pack"] == "frontier_pack"
    assert set(_build.LAUNCHES) == set(_build.KERNELS)
    for source in _build.SOURCES:
        assert (_build.CSRC / f"{source}.cu").is_file(), source


def _probe():
    """scripts/port_kernel_probe.py, which calls the probe entry of the
    tensor-core flash library."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "port_kernel_probe.py"
    spec = importlib.util.spec_from_file_location("port_kernel_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_C_TYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def _c_params(source: str, symbol: str) -> list:
    text = (_build.CSRC / f"{source}.cu").read_text()
    found = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text, re.S)
    assert found, f"{symbol} not in {source}.cu"
    kinds = []
    for param in found.group(1).split(","):
        param = " ".join(param.split())
        kinds.append("ptr" if "*" in param else param.split()[0])
    return [_C_TYPES[k] for k in kinds]


@pytest.mark.parametrize("source,symbol,argtypes", [
    ("ell_combine", "ell_combine_launch", tell._ARGTYPES),
    ("ell_spmm", "ell_spmm_launch", tell._SPMM_ARGTYPES),
    ("frontier_pack", "frontier_pack_launch", tfp._ARGTYPES),
    ("segment_reduce", "segment_reduce_launch", tsr._ARGTYPES),
    ("embedding_bag", "embedding_bag_launch", tbag._ARGTYPES),
    ("flash_attention", "flash_attention_launch", tfa._ARGTYPES),
    ("flash_attention_wgmma", "flash_attention_wgmma_launch", tfa._WGMMA_ARGTYPES),
    ("flash_attention_wgmma", "flash_attention_wgmma_probe", _probe().PROBE_ARGTYPES)])
def test_ctypes_argtypes_match_the_c_entry_point(source, symbol, argtypes):
    """Same arity, and a pointer, int or float in each place: ctypes would
    otherwise pass a 64-bit pointer as a 32-bit int, or shift every
    argument after a missing one."""
    assert list(argtypes) == _c_params(source, symbol)
