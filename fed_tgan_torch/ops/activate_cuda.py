"""The fused activation kernels (``csrc/activate.cu``) and their wrappers.

- ``fused_apply_activate(x, spec, u)`` (K1) is the port of
  ``fed_tgan_tpu/ops/activate_pallas.py:182``: tanh on tanh segments,
  Gumbel-softmax (tau=0.2, per-segment max stabilised) on softmax
  segments, Gumbel noise built from the explicit uniforms ``u``.  When
  ``x`` requires a gradient it runs through :class:`ActivateFunction`,
  whose backward is K2.
- ``fused_activate_bwd(dy, out, spec)`` (K2) is the analytic backward
  (``activate_pallas.py:102``), from the forward output alone.

Routing: a tensor on the CPU takes the plain version
(:func:`fed_tgan_torch.ops.segments.apply_activate` /
``apply_activate_bwd``); a CUDA tensor always launches the kernel or
raises.  The kernel is compiled from the source in
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

from torch.autograd.function import once_differentiable

from fed_tgan_torch.ops.segments import (
    SegmentSpec,
    apply_activate,
    apply_activate_bwd,
)

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
    lib.fed_tgan_activate_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                          i32, ptr]
    lib.fed_tgan_activate_bwd.restype = i32
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


def _check_rows(name: str, spec: SegmentSpec, a: torch.Tensor,
                b: torch.Tensor) -> None:
    """What both kernels take: two float32, contiguous (N, spec.dim) CUDA
    tensors on one device."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if b.device != a.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or a.shape[1] != spec.dim or b.shape != a.shape:
        raise ValueError(f"{name}: expected operands of shape (N, {spec.dim}),"
                         f" got {tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")


def _launch(fn_name: str, a: torch.Tensor, b: torch.Tensor,
            spec: SegmentSpec) -> torch.Tensor:
    """Run ``fn_name`` of the library on ``a`` and ``b`` into a new tensor,
    on the current stream of their device; raises if the launch fails."""
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    lib = _library()
    seg_start, seg_is_tanh = _device_tables(spec, a.device)
    with torch.cuda.device(a.device):
        err = getattr(lib, fn_name)(
            a.data_ptr(), b.data_ptr(), seg_start.data_ptr(),
            seg_is_tanh.data_ptr(), out.data_ptr(), a.shape[0], spec.dim,
            spec.n_segments, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        msg = lib.fed_tgan_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")
    return out


def _activate(x: torch.Tensor, spec: SegmentSpec,
              u: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return apply_activate(x, spec, u)
    _check_rows("fused_apply_activate", spec, x, u)
    out = _launch("fed_tgan_activate_fwd", x, u, spec)
    fused_apply_activate.launches += 1
    return out


class ActivateFunction(torch.autograd.Function):
    """The activation with K2 as its backward.  First order only: the
    gradient penalty never differentiates through the activation (the D
    step detaches the fake batch), so K2 needs no derivative of its own.
    The uniforms ``u`` never require a gradient."""

    @staticmethod
    def forward(ctx, x, spec, u):
        out = _activate(x, spec, u)
        ctx.spec = spec
        ctx.save_for_backward(out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (out,) = ctx.saved_tensors
        return fused_activate_bwd(dy.contiguous(), out, ctx.spec), None, None


def fused_apply_activate(x: torch.Tensor, spec: SegmentSpec,
                         u: torch.Tensor) -> torch.Tensor:
    """Activation of the raw generator output ``x`` (N, spec.dim) with the
    Gumbel uniforms ``u`` (N, spec.dim); returns a new (N, spec.dim)
    float32 tensor.  CPU tensors take the plain version; CUDA tensors
    launch K1 (one launch, counted in ``launches``) or raise.  When ``x``
    requires a gradient the result's backward is K2
    (:class:`ActivateFunction`)."""
    if x.requires_grad and torch.is_grad_enabled():
        return ActivateFunction.apply(x, spec, u)
    return _activate(x, spec, u)


fused_apply_activate.launches = 0


def fused_activate_bwd(dy: torch.Tensor, out: torch.Tensor,
                       spec: SegmentSpec) -> torch.Tensor:
    """The activation's gradient with respect to ``x`` from the upstream
    gradient ``dy`` and the forward output ``out`` (both (N, spec.dim)
    float32).  CPU tensors take the plain version; CUDA tensors launch K2
    (one launch, counted in ``launches``) or raise."""
    if dy.device.type == "cpu":
        return apply_activate_bwd(dy, out, spec)
    _check_rows("fused_activate_bwd", spec, dy, out)
    dx = _launch("fed_tgan_activate_bwd", dy, out, spec)
    fused_activate_bwd.launches += 1
    return dx


fused_activate_bwd.launches = 0
