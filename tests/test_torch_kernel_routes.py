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


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 8, "flash_attention_bwd_wgmma"),
    (torch.bfloat16, 16, "flash_attention_bwd_wgmma"),
    (torch.bfloat16, 64, "flash_attention_bwd_wgmma"),
    (torch.bfloat16, 96, "flash_attention_bwd_wgmma"),
    (torch.bfloat16, 128, "flash_attention_bwd_wgmma"),
    (torch.bfloat16, 12, "flash_attention_bwd"), (torch.bfloat16, 70, "flash_attention_bwd"),
    (torch.float32, 8, "flash_attention_bwd"), (torch.float32, 64, "flash_attention_bwd"),
    (torch.float32, 128, "flash_attention_bwd"), (torch.float32, 12, "flash_attention_bwd")])
def test_flash_backward_route_follows_the_forward_route(dtype, d, kernel):
    """The backward takes wgmma exactly where the forward does (bfloat16
    with D % 8 == 0); the rest takes the TF32 mma.sync kernel, as the
    forward's rest does."""
    assert tfa.route_bwd(dtype, d) == kernel
    assert (kernel == tfa.BACKWARD_WGMMA) == (tfa.route(dtype, d) == tfa.TENSOR_CORES)


@pytest.mark.parametrize("b,hq,sq,rows", [(1, 1, 1, 128), (2, 3, 128, 128), (2, 3, 129, 256),
                                          (8, 16, 1024, 1024), (1, 4, 1000, 1024)])
def test_wgmma_backward_scratch_pads_each_head_to_128_rows(b, hq, sq, rows):
    """Two float32 planes (lse in the log2 domain, Delta) of B * Hq rows of
    Sq rounded up to 128, on both backward routes: the stride the C entries
    compute, a multiple of 4 floats as TMA and 16-byte cp.async need, and
    room for a dQ block's rows."""
    assert tfa.bwd_stats_floats(b, hq, sq) == 2 * b * hq * rows


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 12), (torch.float32, 128)])
@pytest.mark.parametrize("lse_shape", [None, (1, 2, 3)])
def test_every_flash_backward_takes_the_forwards_lse(dtype, d, lse_shape):
    """Both backward routes read the forward's log-sum-exp (B, Hq, Sq): a
    call without one, or with one of another shape, raises before any tensor
    is checked or launched."""
    q = torch.ones(1, 2, 4, d, dtype=dtype)
    k = torch.ones(1, 1, 4, d, dtype=dtype)
    given = None if lse_shape is None else torch.zeros(lse_shape)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd_cuda(q, k, k, q, q, True, given)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 12),
                                     (torch.bfloat16, 64)])
def test_both_flash_forwards_keep_lse(dtype, d):
    """`with_lse` is taken on both forward routes (the TF32 one as well as
    wgmma): on CPU tensors the call gets past it to the tensor checks, which
    refuse a CPU tensor."""
    q = torch.ones(1, 2, 4, d, dtype=dtype)
    k = torch.ones(1, 1, 4, d, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, k, k, True, with_lse=True)


@pytest.mark.parametrize("d,dp", [(1, 16), (12, 16), (16, 16), (17, 32), (64, 64), (70, 96),
                                  (96, 96), (97, 128), (128, 128)])
def test_tf32_scratch_holds_the_split_planes(d, dp):
    """The TF32 kernel pads D to 16, 32, 64, 96 or 128 and reads K as 2 DP
    floats a kv row and V as 4 DP floats a pair of kv rows (an odd Skv pads
    its last pair), the room the C entry checks."""
    assert tfa.tf32_padded_dim(d) == dp
    assert tfa.tf32_scratch_floats(2, 3, 7, d) == 2 * 3 * (7 * 2 * dp + 4 * 4 * dp)


def test_both_flash_kernels_and_frontier_pack_are_registered():
    """Every kernel has a source and a launch counter; the batched pull has
    a source of its own."""
    assert _build.KERNELS["flash_attention"] == "flash_attention_wgmma"
    assert _build.KERNELS["flash_attention_f32"] == "flash_attention"
    assert _build.KERNELS["frontier_pack"] == "frontier_pack"
    assert _build.KERNELS["ell_combine_batched"] == "ell_combine_batched"
    assert _build.KERNELS["flash_attention_bwd"] == "flash_attention_bwd"
    assert _build.KERNELS["flash_attention_bwd_wgmma"] == "flash_attention_bwd_wgmma"
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
    ("ell_combine_batched", "ell_combine_batched_launch", tell._BATCHED_ARGTYPES),
    ("ell_spmm", "ell_spmm_launch", tell._SPMM_ARGTYPES),
    ("frontier_pack", "frontier_pack_launch", tfp._ARGTYPES),
    ("segment_reduce", "segment_reduce_launch", tsr._ARGTYPES),
    ("embedding_bag", "embedding_bag_launch", tbag._ARGTYPES),
    ("flash_attention", "flash_attention_launch", tfa._ARGTYPES),
    ("flash_attention_wgmma", "flash_attention_wgmma_launch", tfa._WGMMA_ARGTYPES),
    ("flash_attention_bwd", "flash_attention_bwd_launch", tfa._BWD_ARGTYPES),
    ("flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma_launch", tfa._BWD_WGMMA_ARGTYPES),
    ("flash_attention_wgmma", "flash_attention_wgmma_probe", _probe().PROBE_ARGTYPES)])
def test_ctypes_argtypes_match_the_c_entry_point(source, symbol, argtypes):
    """Same arity, and a pointer, int or float in each place: ctypes would
    otherwise pass a 64-bit pointer as a 32-bit int, or shift every
    argument after a missing one."""
    assert list(argtypes) == _c_params(source, symbol)


def _c_names(source: str, symbol: str) -> list:
    text = (_build.CSRC / f"{source}.cu").read_text()
    found = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text, re.S)
    return [" ".join(p.split()).split()[-1].lstrip("*") for p in found.group(1).split(",")]


@pytest.mark.parametrize("symbol,argtypes", [
    ("flash_attention_wgmma_launch", tfa._WGMMA_ARGTYPES),
    ("flash_attention_wgmma_probe", _probe().PROBE_ARGTYPES)])
def test_wgmma_forward_takes_lse_after_the_output(symbol, argtypes):
    """The forward's optional log-sum-exp pointer sits after `out` in both
    entries, and ctypes passes a pointer there (None for no lse)."""
    names = _c_names("flash_attention_wgmma", symbol)
    assert names[:5] == ["q", "k", "v", "out", "lse"]
    assert argtypes[4] is ctypes.c_void_p


def test_wgmma_backward_takes_lse_and_scratch_pointers_in_order():
    """q, k, v, out, dout, lse, dq, dk, dv, stats: ten pointers, as the
    wrapper passes them."""
    names = _c_names("flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma_launch")
    assert names[:10] == ["q", "k", "v", "out", "dout", "lse", "dq", "dk", "dv", "stats"]
    assert tfa._BWD_WGMMA_ARGTYPES[:10] == (ctypes.c_void_p,) * 10


def test_tf32_forward_takes_lse_after_the_output():
    """The TF32 forward's optional log-sum-exp pointer sits after `out`, in
    the wgmma entry's place, and ctypes passes a pointer there (None for no
    lse); the split planes' scratch and its size follow."""
    names = _c_names("flash_attention", "flash_attention_launch")
    assert names[:7] == ["q", "k", "v", "out", "lse", "scratch", "scratch_floats"]
    assert tfa._ARGTYPES[4] is ctypes.c_void_p
    assert tfa._ARGTYPES[:5] == tfa._WGMMA_ARGTYPES[:5]


def test_tf32_backward_takes_the_wgmma_backwards_pointers_in_order():
    """q, k, v, out, dout, lse, dq, dk, dv, stats: ten pointers in both
    backward entries, then the same shape arguments; the TF32 entry adds the
    dtype before the stream."""
    names = _c_names("flash_attention_bwd", "flash_attention_bwd_launch")
    assert names[:10] == ["q", "k", "v", "out", "dout", "lse", "dq", "dk", "dv", "stats"]
    assert names[10:] == _c_names("flash_attention_bwd_wgmma",
                                  "flash_attention_bwd_wgmma_launch")[10:-1] + ["dtype", "stream"]
    assert tfa._BWD_ARGTYPES[:10] == (ctypes.c_void_p,) * 10
    assert tfa._BWD_ARGTYPES[:-2] == tfa._BWD_WGMMA_ARGTYPES[:-1]
