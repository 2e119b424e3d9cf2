"""J03 good twin: builds hoisted or cached, branches on the device or on
metadata -- zero findings."""
import torch

from fed_tgan_torch.runtime.cache import built_once


def compile_once(model, steps):
    fn = torch.compile(model)
    for s in range(steps):
        fn(s)


@built_once(maxsize=4)
def tables(spec, device):
    return torch.zeros(spec, device=device)


def value_branch(x: torch.Tensor, steps):
    for s in range(steps):
        x = torch.where(x.sum() > 0, x * 0.5, x)
        if x is None or x.shape[0] == 0 or isinstance(x, list):
            break
    return x
