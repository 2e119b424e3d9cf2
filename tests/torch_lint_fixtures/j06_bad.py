"""J06 bad twin: float64 requested on the device.

Never imported -- parsed by the linter only.
"""
import numpy as np
import torch

F64 = torch.float64


def upcast(x: torch.Tensor):
    return x.double()  # EXPECT: J06


def to_f64(x: torch.Tensor):
    return x.to(torch.float64)  # EXPECT: J06


def make(n, device):
    return torch.zeros(n, dtype=torch.float64, device=device)  # EXPECT: J06


def from_host(device):
    grid = np.linspace(0.0, 1.0, 8)
    a = torch.as_tensor(grid, device=device)  # EXPECT: J06
    b = torch.from_numpy(np.zeros(4)).to(device)  # EXPECT: J06
    return a, b


def alias(values, device, dtype=F64):
    return torch.as_tensor(values, dtype=dtype, device=device)  # EXPECT: J06


def mixed(x: torch.Tensor):
    return x * np.float64(0.5)  # EXPECT: J06
