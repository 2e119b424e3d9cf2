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

Both kernels give each block a tile of ``rows_per_tile`` consecutive
rows, copied into shared memory asynchronously (rows too wide for that
run unstaged, one per block).  :func:`launch_plan` chooses the tile and
the shared memory from ``(N, D, S)`` on the host, so the CPU tests can
check it.  The per-dim codes and segment offsets the kernels read are
copied to the card once per spec object and device, and the plans are
cached per shape.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
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

THREADS = 256  # kThreads in activate.cu
SMEM_BLOCK = 232_448  # the shared memory one block may take on sm_90 (227 KB)
SMEM_SM = 233_472  # one SM's shared memory (228 KB) ...
SMEM_RESERVED = 1_024  # ... less what the runtime keeps for each block
MAX_BLOCKS_PER_SM = 2048 // THREADS  # registers are capped to allow it
H100_SMS = 132
# bytes of both operands of one tile: 16 rows of the 282-wide Intrusion
# layout, the fastest tile at 64,000 rows on the H100
TILE_BYTES = 36 * 1024
TANH_BIT = 0x8000  # bit 15 of a per-dim code; bits 0-14 are the segment
MAX_SEGMENTS = TANH_BIT


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
    for name in ("fed_tgan_activate_fwd", "fed_tgan_activate_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr] + [i32] * 6 + [ptr]
        fn.restype = i32
    lib.fed_tgan_activate_prepare.restype = i32
    lib.fed_tgan_activate_threads.restype = i32
    lib.fed_tgan_cuda_error_string.argtypes = [i32]
    lib.fed_tgan_cuda_error_string.restype = ctypes.c_char_p
    if lib.fed_tgan_activate_threads() != THREADS:
        raise RuntimeError(f"{SOURCE.name} launches "
                           f"{lib.fed_tgan_activate_threads()} threads a "
                           f"block; the plan assumes {THREADS}")
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fed_tgan_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def segment_tables(spec: SegmentSpec) -> tuple[np.ndarray, np.ndarray]:
    """The layout's per-segment tables: ``seg_start`` (S+1,) int32 offsets
    (the kernels' pair passes read them) and ``seg_is_tanh`` (S,) uint8
    flags."""
    sizes = [size for size, _ in spec.output_info]
    start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    is_tanh = np.asarray([kind == "tanh" for _, kind in spec.output_info],
                         dtype=np.uint8)
    return start, is_tanh


def dim_tables(spec: SegmentSpec) -> tuple[np.ndarray, np.ndarray]:
    """The per-dim tables: segment index (D,) uint16 and tanh flag (D,)
    uint8, built from ``output_info`` alone."""
    start, is_tanh = segment_tables(spec)
    sizes = np.diff(start)
    return (np.repeat(np.arange(spec.n_segments), sizes).astype(np.uint16),
            np.repeat(is_tanh, sizes))


def dim_codes(spec: SegmentSpec) -> np.ndarray:
    """What the kernels stage per dim: the segment index, with
    :data:`TANH_BIT` set on tanh dims, (D,) uint16."""
    if spec.n_segments > MAX_SEGMENTS:
        raise ValueError(f"{spec.n_segments} segments: the kernels take at "
                         f"most {MAX_SEGMENTS}")
    seg, tanh = dim_tables(spec)
    return seg | (tanh.astype(np.uint16) * TANH_BIT)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(rows_per_tile: int, dim: int, n_segments: int,
               staged: bool = True) -> int:
    """Dynamic shared memory of one block, as ``stage_tables()`` in
    activate.cu lays it out: 2 operand buffers of R*D floats (+3 for the
    tile's misalignment), the (row, segment) results (2 floats each), the
    segment offsets and the per-dim codes; unstaged, the results alone."""
    results = _round4(2 * rows_per_tile * n_segments)
    if not staged:
        return 4 * results
    floats = (2 * _round4(rows_per_tile * dim + 3) + results
              + _round4(n_segments + 1))
    return 4 * floats + (-(-2 * dim // 16)) * 16


def blocks_per_sm(smem: int) -> int:
    """Blocks of :data:`THREADS` threads that fit on one SM with ``smem``
    bytes of shared memory each (registers are capped so as never to be
    the limit)."""
    return min(MAX_BLOCKS_PER_SM, SMEM_SM // (smem + SMEM_RESERVED))


@dataclass(frozen=True)
class LaunchPlan:
    rows_per_tile: int  # R: the rows of one block
    tiles: int  # the grid: one block per tile
    smem_bytes: int
    blocks_per_sm: int  # how many blocks an SM holds at once
    staged: bool  # False: operands and tables read from global memory

    def as_dict(self) -> dict:
        return {"rows_per_tile": self.rows_per_tile, "blocks": self.tiles,
                "threads": THREADS, "smem_bytes": self.smem_bytes,
                "blocks_per_sm": self.blocks_per_sm, "staged": self.staged}


def launch_plan(n_rows: int, dim: int, n_segments: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The launch of either kernel over ``n_rows`` rows of width ``dim``
    in ``n_segments`` segments on a card of ``sms`` SMs: one block of
    :data:`THREADS` threads per tile of R rows.

    R starts at the smaller of what keeps a tile's two operands near
    :data:`TILE_BYTES` and ``n_rows // sms`` (so that every SM gets a tile:
    500 rows on 132 SMs give R = 3, 167 tiles), and shrinks until the block
    fits in shared memory.  Where a smaller R would fill every SM with as
    many blocks as it holds (one full wave), the largest such R is taken:
    a last wave that is mostly empty costs a whole block's lifetime.

    Where not even one row of both operands and the tables fits (D above
    ~23,000 for a few hundred segments), each block takes one row
    unstaged.  Raises ``ValueError`` above D = ``SMEM_BLOCK // 8`` (29,056),
    where one row of both operands alone would fill a block's shared
    memory."""
    if n_rows < 1 or dim < 1:
        raise ValueError(f"no work in a ({n_rows}, {dim}) launch")
    if 8 * dim > SMEM_BLOCK:
        raise ValueError(f"rows of width {dim}: the kernels take rows of at "
                         f"most {SMEM_BLOCK // 8} floats")
    if smem_bytes(1, dim, n_segments) > SMEM_BLOCK:
        smem = smem_bytes(1, dim, n_segments, staged=False)
        return LaunchPlan(1, n_rows, smem, blocks_per_sm(smem), staged=False)
    rows = max(1, min(TILE_BYTES // (8 * dim), n_rows // sms))
    while smem_bytes(rows, dim, n_segments) > SMEM_BLOCK:
        rows -= 1
    for r in range(rows, 0, -1):
        per_sm = blocks_per_sm(smem_bytes(r, dim, n_segments))
        if -(-n_rows // r) >= sms * per_sm:
            rows = r
            break
    smem = smem_bytes(rows, dim, n_segments)
    return LaunchPlan(rows, -(-n_rows // rows), smem, blocks_per_sm(smem),
                      staged=True)


_plan = functools.lru_cache(maxsize=256)(launch_plan)


class _Prepared:
    """One spec on one device: its tables on the card and the device's
    SM count."""

    def __init__(self, spec: SegmentSpec, index: int):
        lib = _library()
        with torch.cuda.device(index):
            _check(lib, lib.fed_tgan_activate_prepare(),
                   "fed_tgan_activate_prepare")
        dev = torch.device("cuda", index)
        self.sms = torch.cuda.get_device_properties(index).multi_processor_count
        # padded to whole 16-byte copies, as the kernels stage them
        codes = np.zeros(-(-spec.dim // 8) * 8, dtype=np.uint16)
        codes[:spec.dim] = dim_codes(spec)
        start = np.zeros(_round4(spec.n_segments + 1), dtype=np.int32)
        start[:spec.n_segments + 1] = segment_tables(spec)[0]
        self.codes = torch.as_tensor(codes.view(np.int16), device=dev)
        self.start = torch.as_tensor(start, device=dev)
        self.codes_ptr = self.codes.data_ptr()
        self.start_ptr = self.start.data_ptr()


@functools.lru_cache(maxsize=64)
def _prepared(spec: SegmentSpec, index: int) -> _Prepared:
    return _Prepared(spec, index)


def plan_for(a: torch.Tensor, spec: SegmentSpec) -> LaunchPlan:
    """The plan a launch over the CUDA tensor ``a`` (N, spec.dim) takes."""
    sms = _prepared(spec, a.get_device()).sms
    return _plan(a.shape[0], spec.dim, spec.n_segments, sms)


def _check_rows(name: str, spec: SegmentSpec, a: torch.Tensor,
                b: torch.Tensor) -> None:
    """What both kernels take: two float32, contiguous (N, spec.dim) CUDA
    tensors on one device.  (Device indices, not device objects: this runs
    on every launch.)"""
    if not a.is_cuda:
        raise ValueError(f"{name}: unsupported device {a.device}")
    if b.get_device() != a.get_device():
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
    on the current stream of their device, with :func:`launch_plan`'s
    plan; raises if the launch fails."""
    out = torch.empty_like(a)
    n_rows = a.shape[0]
    if n_rows == 0:
        return out
    lib = _library()
    index = a.get_device()
    prep = _prepared(spec, index)
    plan = _plan(n_rows, spec.dim, spec.n_segments, prep.sms)
    args = (a.data_ptr(), b.data_ptr(), prep.codes_ptr, prep.start_ptr,
            out.data_ptr(), n_rows, spec.dim, spec.n_segments,
            plan.rows_per_tile, int(plan.staged), plan.smem_bytes,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = getattr(lib, fn_name)(*args)
    else:
        with torch.cuda.device(index):
            err = getattr(lib, fn_name)(*args)
    _check(lib, err, f"{fn_name} launch")
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
