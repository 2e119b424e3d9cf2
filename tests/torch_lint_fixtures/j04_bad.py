"""J04 bad twin: host numpy applied to device tensors.

Never imported -- parsed by the linter only.
"""
import numpy as np
import torch


def summarize(x: torch.Tensor):
    return np.mean(x)  # EXPECT: J04


def to_host(model, device):
    out = model(torch.ones(3, device=device))
    arr = np.asarray(out)  # EXPECT: J04
    return np.concatenate([arr, np.array(out.sum())])  # EXPECT: J04
