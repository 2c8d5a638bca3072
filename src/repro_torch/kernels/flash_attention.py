"""Causal GQA attention: the flash kernel and its plain version.

Port of `repro.kernels.flash_attention.flash_attention` (the Pallas
`_flash_kernel`). q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), float32 or
bfloat16 -> (B, Hq, Sq, D) in q's dtype. Query head h reads kv head
h % Hkv: the group-major map of the Pallas index map (flash_attention.py
:119) and of `ref.attention_ref`. (The Pallas module docstring's
"h // group" is stale, and torch's `enable_gqa` uses h // group, the other
map.) With `causal`, query i sees kv positions <= i + Skv - Sq.

On the card there are two kernels, and `route(dtype, D)` picks one:
bfloat16 with D % 8 == 0 goes to the tensor cores,
`csrc/flash_attention_wgmma.cu` (`wgmma` fed by TMA, counted as
`flash_attention`); float32, and bfloat16 with D % 8 != 0 (TMA needs
16-byte row strides), go to the CUDA cores, `csrc/flash_attention.cu`
(counted as `flash_attention_f32`). Both run an online softmax over kv
tiles with float32 statistics, round P to bfloat16 before P.V for
bfloat16 inputs, and take any Sq and Skv and D up to 128. The plain
version is `ref.attention_ref`'s formulation: kv heads tiled group-major,
scores in q's dtype, softmax in float32, P cast to q's dtype. Each kernel
and the plain version agree within 2e-4 in float32 and 5e-2 in bfloat16, and
in bfloat16 also within BF16_REL_ERR in relative norm (||kernel - plain|| /
||plain||): outputs average many values of v and are small at long Skv, so
an absolute 5e-2 alone would pass a kernel that drops keys. The sharp
bfloat16 check is against `attention_rounded`, the plain version that
rounds where the kernels round (float32 scores, P rounded to bfloat16, a
float32 P.V, the output rounded to bfloat16), within ROUNDED_REL_ERR in
relative norm.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: the two kernels, by their names in `_build.KERNELS`
TENSOR_CORES, CUDA_CORES = "flash_attention", "flash_attention_f32"
#: bfloat16 kernel vs plain version, ||a - p|| / ||p||: the worst reading
#: on an H100 (chip_smoke.py's sweep and granite shapes) is 6.2e-3 on the
#: tensor cores and 5.9e-3 on the CUDA cores. The plain version rounds its
#: scores to bfloat16 and the kernels do not; that gap hides small faults
#: such as one dropped key in a long row
BF16_REL_ERR = 1e-2
#: bfloat16 kernel vs `attention_rounded`, ||a - r|| / ||r||: what is left is
#: the rounding of P against a running rather than the final row max, and of
#: the output (about 2e-3); dropping one key from rows of 1,024 keys moves
#: the output by about 3e-2
ROUNDED_REL_ERR = 5e-3


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


def attention_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Plain version at the flash kernels' rounding points: scores q.k in
    float32, softmax statistics in float32, the unnormalised P rounded to
    q's dtype before a float32 P.V, divided by the float32 row sum of the
    unrounded P, and the output rounded to q's dtype."""
    _, hq, hkv, sq, skv, d = _shapes(q, k, v)
    group = hq // hkv
    kk = k.repeat(1, group, 1, 1).float()          # group-major: head h -> h % hkv
    vv = v.repeat(1, group, 1, 1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (1.0 / d ** 0.5)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), vv)
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes inputs of `dtype` and head dim `d` on the card:
    the tensor cores for bfloat16 with d % 8 == 0, else the CUDA cores."""
    return TENSOR_CORES if dtype == torch.bfloat16 and d % 8 == 0 else CUDA_CORES


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)
_WGMMA_ARGTYPES = _ARGTYPES[:12] + _ARGTYPES[13:]      # no dtype argument


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel that `route` picks, on PyTorch's current stream."""
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
    kernel = route(q.dtype, d)
    args = (p_q, p_k, p_v, out.data_ptr(), b, hq, hkv, sq, skv, d, 1.0 / (d ** 0.5),
            int(causal))
    if kernel == TENSOR_CORES:
        if any(p % 16 for p in (p_q, p_k, p_v)):
            raise ValueError("q, k and v must be 16-byte aligned for TMA")
        fn = _build.entry("flash_attention_wgmma", "flash_attention_wgmma_launch",
                          _WGMMA_ARGTYPES)
    else:
        fn = _build.entry("flash_attention", "flash_attention_launch", _ARGTYPES)
        args += (DTYPES[q.dtype],)
    with _build.device_guard(dev):
        err = fn(*args, _build.stream_of(dev))
    _build.check(err, kernel)
    _build.LAUNCHES[kernel] += 1
    return out
