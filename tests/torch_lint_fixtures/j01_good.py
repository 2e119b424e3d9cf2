"""J01 good twin: the loop stays on the device and the host reads once,
inside ``sanctioned_sync()`` -- zero findings."""
import numpy as np
import torch

from fed_tgan_torch.analysis.sanitizers import sanctioned_sync


def fit_loop(model, steps, device):
    acc = torch.zeros(steps, device=device)
    for s in range(steps):
        acc[s] = model(torch.ones(4, device=device))
    with sanctioned_sync():  # the one batched copy, after the loop
        host = acc.cpu().numpy()
    return host.mean()


def chunk_loop(model, chunks, device):
    out = []
    for c in range(chunks):
        res = model(torch.ones(4, device=device))
        with sanctioned_sync():  # one copy per chunk, by design
            out.append(res.cpu().numpy())
    return np.concatenate(out)


def metadata(xs: torch.Tensor, steps):
    n = 0
    for s in range(steps):
        n += xs.shape[0] + xs.numel()
    return n
