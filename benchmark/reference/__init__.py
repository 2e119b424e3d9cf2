"""The plain reference of a federated CTGAN run, in PyTorch and NumPy.

It imports nothing of the program (``fed_tgan_torch``), of the JAX
package or of JAX.  From the raw table it works out again what the
program's set-up derives (the shards, the harmonized categories, the
mixture fits, the similarity weights, the encoded matrices, the initial
models) and follows the first rounds client by client, with no stacking,
in float32 with TF32 off (:mod:`.init`, :mod:`.ctgan`, :mod:`.sample`).
The random draws are the program's documented streams, made again here
from the seed: the reference never reads a tensor the program made.
"""
