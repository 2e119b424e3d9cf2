"""J01 bad twin: host syncs on device tensors inside hot loops.

Never imported -- parsed by the linter only.  ``# EXPECT: JXX`` marks
the exact (rule, line) pairs the tests assert.
"""
import numpy as np
import torch


def fit_loop(model, steps, device):
    losses = []
    for s in range(steps):
        loss = model(torch.ones(4, device=device))
        losses.append(loss.item())  # EXPECT: J01
        print(float(loss))  # EXPECT: J01
        host = loss.cpu()  # EXPECT: J01
        losses.append(np.asarray(loss))  # EXPECT: J01
    return losses, host


def helper_called_from_loop(metrics):
    return metrics.tolist()  # EXPECT: J01


def driver(model, steps, device):
    for s in range(steps):
        metrics = model(torch.zeros(3, device=device))
        helper_called_from_loop(metrics)


def comprehension_pull(xs: torch.Tensor):
    return [int(x) for x in xs]  # EXPECT: J01
