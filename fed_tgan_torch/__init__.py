"""PyTorch + CUDA port of fed_tgan_tpu, slice 1: the serving path.

Importing the package pins float32 matrix products and convolutions to
full float32 (TF32 off) on CUDA, so results on the card compare with the
JAX reference at float32 tolerances.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
