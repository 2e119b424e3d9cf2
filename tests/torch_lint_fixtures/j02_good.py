"""J02 good twin: every draw names its generator, and every stream gets
its own seed -- zero findings."""
import numpy as np
import torch


def step_seed(stream, step):
    return hash((stream, step)) % 2**63


def draws(n, device, gen):
    z = torch.randn((n, 4), generator=gen, device=device)
    u = torch.rand((n, 4), generator=gen, device=device)
    keep = torch.empty(n, device=device).bernoulli_(0.5, generator=gen)
    return z, u, keep


def two_streams(seed):
    g1 = torch.Generator().manual_seed(step_seed(seed, 1))
    g2 = torch.Generator().manual_seed(step_seed(seed, 2))
    return torch.rand(3, generator=g1), torch.rand(3, generator=g2)


def reseed_per_step(seed, steps):
    g = torch.Generator()
    out = []
    for s in range(steps):
        g.manual_seed(step_seed(seed, s))
        out.append(torch.rand(3, generator=g))
    return out


def host_rng(seed):
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)  # the global generator: seeding is no draw
    return rng.normal(0.0, 1.0, 8)
