"""The fused activation kernel (``csrc/activate.cu``) and its wrapper.

``fused_apply_activate(x, spec, u)`` is the port of
``fed_tgan_tpu/ops/activate_pallas.py:182``: tanh on tanh segments,
Gumbel-softmax (tau=0.2, per-segment max stabilised) on softmax segments,
Gumbel noise built from the explicit uniforms ``u``.

Routing: a tensor on the CPU takes the plain version,
:func:`fed_tgan_torch.ops.segments.apply_activate`; a CUDA tensor always
launches the kernel or raises.  The kernel is compiled from the source in
this package with ``nvcc`` for ``sm_90a`` at first use, into
``fed_tgan_torch/_build/``, and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from fed_tgan_torch.ops.segments import SegmentSpec, apply_activate

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "activate.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           f"build {SOURCE.name}")
    return nvcc


@functools.lru_cache(maxsize=None)
def build() -> tuple[str, str]:
    """Compile the kernel source (once per source content) and return
    ``(library path, compiler output)``; the output carries ptxas's
    register and shared-memory report."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libfed_tgan_activate_{tag}.so"
    if lib.exists():
        return str(lib), ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return str(lib), proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fed_tgan_activate_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                          i32, ptr]
    lib.fed_tgan_activate_fwd.restype = i32
    lib.fed_tgan_cuda_error_string.argtypes = [i32]
    lib.fed_tgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def segment_tables(spec: SegmentSpec) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's layout operands: ``seg_start`` (S+1,) int32 offsets and
    ``seg_is_tanh`` (S,) uint8 flags."""
    sizes = [size for size, _ in spec.output_info]
    start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    is_tanh = np.asarray([kind == "tanh" for _, kind in spec.output_info],
                         dtype=np.uint8)
    return start, is_tanh


@functools.lru_cache(maxsize=64)
def _device_tables(spec: SegmentSpec, device: torch.device):
    start, is_tanh = segment_tables(spec)
    return (torch.as_tensor(start, device=device),
            torch.as_tensor(is_tanh, device=device))


def fused_apply_activate(x: torch.Tensor, spec: SegmentSpec,
                         u: torch.Tensor) -> torch.Tensor:
    """Activation of the raw generator output ``x`` (N, spec.dim) with the
    Gumbel uniforms ``u`` (N, spec.dim); returns a new (N, spec.dim)
    float32 tensor.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (one launch, counted in ``launches``) or raise."""
    if x.device.type == "cpu":
        return apply_activate(x, spec, u)
    if x.device.type != "cuda":
        raise ValueError(f"fused_apply_activate: unsupported device {x.device}")
    if u.device != x.device:
        raise ValueError(f"x on {x.device} but u on {u.device}")
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"expected float32 x and u, got {x.dtype}, {u.dtype}")
    if x.dim() != 2 or x.shape[1] != spec.dim or u.shape != x.shape:
        raise ValueError(f"expected x and u of shape (N, {spec.dim}), got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("x and u must be contiguous")
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    lib = _library()
    seg_start, seg_is_tanh = _device_tables(spec, x.device)
    with torch.cuda.device(x.device):
        err = lib.fed_tgan_activate_fwd(
            x.data_ptr(), u.data_ptr(), seg_start.data_ptr(),
            seg_is_tanh.data_ptr(), out.data_ptr(), x.shape[0], spec.dim,
            spec.n_segments, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.fed_tgan_cuda_error_string(err).decode()
        raise RuntimeError(f"activate kernel launch failed: {msg} ({err})")
    fused_apply_activate.launches += 1
    return out


fused_apply_activate.launches = 0
