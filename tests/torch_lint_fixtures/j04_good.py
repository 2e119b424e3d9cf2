"""J04 good twin: numpy only on host copies and host data -- zero
findings."""
import numpy as np
import torch


def summarize(x: torch.Tensor):
    return np.mean(x.cpu().numpy())


def to_host(model, device):
    out = model(torch.as_tensor(np.arange(3.0, dtype=np.float32),
                                device=device))
    arr = np.asarray(out.detach().cpu())
    return np.concatenate([arr, np.zeros(3, dtype=np.float32)])
