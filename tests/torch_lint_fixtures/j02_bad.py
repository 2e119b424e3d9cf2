"""J02 bad twin: draws from the global generator, and generators seeded
alike.

Never imported -- parsed by the linter only.
"""
import torch
import torch.nn.functional as F


def draws(n, device):
    z = torch.randn((n, 4), device=device)  # EXPECT: J02
    u = torch.rand((n, 4), device=device)  # EXPECT: J02
    mask = F.dropout(z, 0.5)  # EXPECT: J02
    noise = torch.empty(n, device=device).normal_()  # EXPECT: J02
    return z, u, mask, noise


def twin_streams(seed):
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)  # EXPECT: J02
    return torch.rand(3, generator=g1), torch.rand(3, generator=g2)


def reseed_in_loop(seed, steps):
    g = torch.Generator()
    out = []
    for s in range(steps):
        g.manual_seed(seed)  # EXPECT: J02
        out.append(torch.rand(3, generator=g))
    return out
