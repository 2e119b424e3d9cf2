"""J06 good twin: float64 stays on the host, device tensors are float32
-- zero findings."""
import numpy as np
import torch


def host_f64(values):
    return torch.as_tensor(np.asarray(values), dtype=torch.float64)


def downcast(device):
    return torch.as_tensor(np.linspace(0.0, 1.0, 8), dtype=torch.float32,
                           device=device)


def moved(device):
    return torch.from_numpy(np.zeros(4, dtype=np.float32)).to(device)


def scalar(x: torch.Tensor):
    return x * 0.5


def host_stats(x: torch.Tensor):
    return x.cpu().double()
