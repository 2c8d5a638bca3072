"""Causal GQA attention: the flash kernel and its plain version.

Port of `repro.kernels.flash_attention.flash_attention` (the Pallas
`_flash_kernel`). q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), float32 or
bfloat16 -> (B, Hq, Sq, D) in q's dtype. Query head h reads kv head
h % Hkv: the group-major map of the Pallas index map (flash_attention.py
:119) and of `ref.attention_ref`. (The Pallas module docstring's
"h // group" is stale, and torch's `enable_gqa` uses h // group, the other
map.) With `causal`, query i sees kv positions <= i + Skv - Sq.

The CUDA kernel is `csrc/flash_attention.cu` (online softmax over kv tiles,
float32 statistics, P rounded to bfloat16 before P.V for bfloat16 inputs,
any Sq and Skv). The plain version is `ref.attention_ref`'s formulation: kv
heads tiled group-major, scores in q's dtype, softmax in float32, P cast to
q's dtype. The two agree within 2e-4 in float32 and 5e-2 in bfloat16, and
in bfloat16 also within BF16_REL_ERR in relative norm (||kernel - plain|| /
||plain||): outputs average many values of v and are small at long Skv, so
an absolute 5e-2 alone would pass a kernel that drops keys.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: bfloat16 kernel vs plain version, ||a - p|| / ||p||: the worst reading
#: on an H100 (chip_smoke.py's sweep and granite shapes) is 5.9e-3, so this
#: bf16 rounding floor hides small faults such as one dropped key in a long
#: row; the float32 check (2e-4) at the same shapes is the sharp one
BF16_REL_ERR = 1e-2


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected (B, Hq, Sq, D) and two (B, Hkv, Skv, D)")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair "
                         "(batch, head dim, or Hq % Hkv)")
    return b, hq, k.shape[1], sq, k.shape[2], d


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version, as `ref.attention_ref` computes it."""
    _, hq, hkv, sq, skv, d = _shapes(q, k, v)
    group = hq // hkv
    kk = k.repeat(1, group, 1, 1)                  # group-major: head h -> h % hkv
    vv = v.repeat(1, group, 1, 1)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale.to(q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, float("-inf"))
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch `csrc/flash_attention.cu` on PyTorch's current stream."""
    dev = q.device
    b, hq, hkv, sq, skv, d = _shapes(q, k, v)
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    p_q = _build.require(q, "q", q.dtype, 4, dev)
    p_k = _build.require(k, "k", q.dtype, 4, dev)
    p_v = _build.require(v, "v", q.dtype, 4, dev)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if skv < 1:
        raise ValueError("no kv positions")
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(p_q, p_k, p_v, out.data_ptr(), b, hq, hkv, sq, skv, d,
                 1.0 / (d ** 0.5), int(causal), DTYPES[q.dtype],
                 _build.stream_of(dev))
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
