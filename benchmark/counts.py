"""Work counted from shapes: the FLOPs a federated CTGAN local step needs
and the bytes and operations of the activation kernels, with the chip's
peaks.

A local step of one client, batch B, pac p, noise width e, encoded width
D and conditional width C (every matrix product counted as 2 m k n, the
elementwise work left out):

- critic update: the generator forward (no gradient); the critic on the
  fake and on the real batch, each backward to its weights and, past the
  first layer, to its inputs; the gradient penalty's critic forward, its
  input gradient and the double backward (two products a layer);
- generator update: the generator forward, the critic forward and its
  backward to its input, the generator's backward to its weights and to
  the parts of its inputs that carry a gradient (the blocks' outputs,
  not the noise and conditional vector).

Nothing recomputed is counted, whatever the implementation runs.  K1
reads the logits and writes the activation (8 bytes an element; the
Gumbel uniforms are not counted, a kernel could draw them itself); K2
reads the upstream gradient and the saved output and writes the gradient
(12 bytes an element).
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12   # float32 outside the tensor cores; TF32 is off

K1_BYTES_PER_ELEM = 8
K2_BYTES_PER_ELEM = 12
# operations an element (the kernels' own count, ``chip_smoke.py``): K1 2
# logs, an exp, add, scale, max, subtract, sum, divide, select; K2 a
# multiply-add into the segment sum, subtract, multiply, divide
OPS_PER_ELEM = {"K1": 10, "K2": 5}


def _mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def generator_layers(e: int, C: int, D: int, gen_dims) -> list:
    """``(in, out)`` of the generator's products: each block takes the
    noise, the conditional vector and every earlier block's output."""
    layers, width = [], e + C
    for h in gen_dims:
        layers.append((width, h))
        width += h
    layers.append((width, D))
    return layers


def critic_layers(D: int, C: int, dis_dims, pac: int) -> list:
    dims = [(D + C) * pac, *dis_dims, 1]
    return list(zip(dims[:-1], dims[1:]))


def step_flops(B: int, e: int, C: int, D: int, gen_dims=(256, 256),
               dis_dims=(256, 256), pac: int = 10) -> dict:
    """FLOPs of one local step of one client, by part."""
    g_layers = generator_layers(e, C, D, gen_dims)
    g_fwd = sum(_mm(B, i, o) for i, o in g_layers)
    # input gradients a block's output needs: block j > 0 and the output
    # layer take the earlier blocks' outputs (not the noise and condition)
    g_in_grad = sum(_mm(B, i - (e + C), o) for i, o in g_layers[1:])
    rows = B // pac
    d_layers = critic_layers(D, C, dis_dims, pac)
    d_fwd = sum(_mm(rows, i, o) for i, o in d_layers)
    d_first = _mm(rows, *d_layers[0])
    critic = (g_fwd                          # the fake batch
              + 2 * d_fwd                    # fake and real scores
              + 2 * (d_fwd + d_fwd - d_first)  # their weight and input grads
              + d_fwd + d_fwd + 2 * d_fwd)   # penalty: fwd, grad, double bwd
    generator = (g_fwd + d_fwd + d_fwd       # fwd, critic fwd and input grad
                 + g_fwd + g_in_grad)        # weight and input grads
    return {"critic": critic, "generator": generator,
            "total": critic + generator}


def kernel_bound_s(kernel: str, elements: int) -> float:
    """The least time the chip needs for ``elements`` of K1 or K2: the
    larger of bytes over bandwidth and operations over the float32 peak."""
    per = K1_BYTES_PER_ELEM if kernel == "K1" else K2_BYTES_PER_ELEM
    return max(per * elements / PEAK_BYTES_PER_S,
               OPS_PER_ELEM[kernel] * elements / PEAK_F32_FLOPS)
