"""J03 bad twin: builds inside loops, value branches in hot code.

Never imported -- parsed by the linter only.
"""
import torch

from fed_tgan_torch.ops import activate_cuda
from fed_tgan_torch.runtime.cache import built_once


def compile_per_step(model, steps):
    for s in range(steps):
        fn = torch.compile(model)  # EXPECT: J03
        fn(s)


def build_in_loop(specs):
    for spec in specs:
        activate_cuda.build()  # EXPECT: J03


def capture_per_chunk(chunks):
    for c in chunks:
        g = torch.cuda.CUDAGraph()  # EXPECT: J03
        with torch.cuda.graph(g):  # EXPECT: J03
            c()


def cache_per_call(fns):
    for fn in fns:
        cached = built_once(maxsize=4)(fn)  # EXPECT: J03
        cached()


def value_branch(x: torch.Tensor, steps):
    for s in range(steps):
        if x.sum() > 0:  # EXPECT: J03
            x = x * 0.5
        while (x > 1).any():  # EXPECT: J03
            x = x - 1
    return x
