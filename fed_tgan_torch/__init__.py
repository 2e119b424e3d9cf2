"""PyTorch + CUDA port of fed_tgan_tpu: the serving path (slice 1) and the
standalone CTGAN trainer (slice 2).

Importing the package pins float32 matrix products and convolutions to
full float32 (TF32 off) on CUDA, so results on the card compare with the
JAX reference at float32 tolerances.

It also makes one small, single-threaded call of each transcendental
function the port runs on CPU tensors.  PyTorch's CPU builds compute
them through MKL's vector math, which sets itself up at its first call;
when that first call is a parallel one, one thread's share of the tensor
can come from a less accurate routine (seen as a 4e-5 relative error in
``torch.log`` over one thread's chunk, in about one fresh process in
twenty on a loaded host), which moved the Gumbel noise of the CPU path's
first sample and broke its determinism.  After one serial call of each
function, no parallel call was seen to do so.

Without torch the package still imports, so ``python -m
fed_tgan_torch.obs report|slo|watch`` (stdlib only) runs on a host that
has only Python; every module that computes imports torch itself.
"""

try:
    import torch
except ImportError:  # a host with only Python: the stdlib-only obs CLI
    torch = None

if torch is not None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    for _fn in (torch.log, torch.exp, torch.tanh, torch.sqrt, torch.sin,
                torch.log1p, torch.expm1):
        for _dtype in (torch.float32, torch.float64):
            _fn(torch.full((8,), 0.5, dtype=_dtype))
    del _fn, _dtype
