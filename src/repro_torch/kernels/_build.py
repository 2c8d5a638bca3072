"""Build the CUDA sources under `repro_torch/csrc/` at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface under `<checkout>/build/kernels/`,
then loaded with `ctypes`. The library's file name carries a hash of its
source and of the shared headers (`csrc/*.cuh`), so an edited kernel or
header is rebuilt and a stale library is never loaded.
`build_all()` starts one `nvcc` per source, all together.

Nothing here runs at import time: the CPU tests import every module, and the
CPU has no `nvcc`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: <checkout>/build/kernels (the checkout root holds src/repro_torch/)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: each kernel and the source that holds it (the deletion overlay is a
#: template flag of `ell_combine.cu`, counted apart; the batched engine's
#: Q-wide pull has a source of its own; flash attention has two forward
#: routes, wgmma for bfloat16 and mma.sync in TF32 (3xTF32 for float32) for
#: the rest, and two backward routes by the same rule)
KERNELS = {"ell_combine": "ell_combine", "ell_combine_overlay": "ell_combine",
           "ell_combine_batched": "ell_combine_batched",
           "frontier_pack": "frontier_pack", "segment_reduce": "segment_reduce",
           "ell_spmm": "ell_spmm", "embedding_bag": "embedding_bag",
           "flash_attention": "flash_attention_wgmma",
           "flash_attention_f32": "flash_attention",
           "flash_attention_bwd": "flash_attention_bwd",
           "flash_attention_bwd_wgmma": "flash_attention_bwd_wgmma"}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple, object] = {}
_lock = threading.Lock()

#: kernel launches per wrapper: each CUDA wrapper adds one where it launches
#: its kernel, and nowhere else (read by chip_smoke.py via ops.launch_counts)
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # the headers a source may include
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, target) or None if built."""
    target = _lib_path(name)
    if target.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(target.with_suffix(".log"), "w")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, target, log


def _finish(name: str, job) -> None:
    proc, tmp, target, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc={rc}):\n"
            + target.with_suffix(".log").read_text()[-4000:])
    os.replace(tmp, target)


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one nvcc per source in parallel."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> object:
    """The C entry point `symbol` of `csrc/<name>.cu`, typed for ctypes
    (returns the int that cudaGetLastError() gave)."""
    key = (name, symbol)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def ptxas_report(name: str) -> str:
    """nvcc's `-Xptxas -v` output (registers, shared memory, spills)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require(t, name: str, dtype, ndim: int, device) -> int:
    """Validate a tensor handed to a kernel; return its data pointer."""
    if device.type != "cuda":
        raise ValueError(f"{name}: CUDA kernels take CUDA tensors, got {device}")
    return _check(t, name, dtype, ndim, device)


def require_meta(t, name: str, dtype, ndim: int) -> None:
    """The checks of `require` for a kernel's meta route, which takes meta
    tensors only (a shape function: it allocates what the CUDA wrapper
    allocates and launches nothing)."""
    if t.device.type != "meta":
        raise ValueError(f"{name}: a meta route takes meta tensors, got {t.device}")
    _check(t, name, dtype, ndim, t.device)


def _check(t, name: str, dtype, ndim: int, device) -> int:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def device_guard(device):
    """A context that makes `device` current for a launch; a no-op when it
    already is (entering `torch.cuda.device` costs microseconds of host time,
    more than a small kernel takes on the card)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on `device`, as an int for ctypes (the
    raw handle, without building a `torch.cuda.Stream` object)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
