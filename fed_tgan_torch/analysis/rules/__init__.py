"""The lint's rule registry (counterpart of
``fed_tgan_tpu/analysis/rules/__init__.py``).

Each rule exposes ``rule_id``, ``title``, ``hint`` and
``check(module) -> iter[(rule_id, line, message, hint)]``.  J01-J06 keep
the JAX package's ids in torch idiom (host syncs in hot loops, draws
without a generator, rebuilds and value branches in hot code, numpy on
device tensors, the J05 shim, float64 on the device); L01-L04 are the
locklint concurrency prong (``analysis/concurrency/``).  All share the
driver, the ``# torchlint: disable=<ids>`` escape and the baseline.
"""

from fed_tgan_torch.analysis.concurrency.rules import (
    BlockingUnderLockRule,
    LockLeakRule,
    LockOrderRule,
    UnguardedFieldRule,
)
from fed_tgan_torch.analysis.rules.dtype_promotion import DtypePromotionRule
from fed_tgan_torch.analysis.rules.host_sync import HostSyncRule
from fed_tgan_torch.analysis.rules.numpy_in_jit import NumpyInJitRule
from fed_tgan_torch.analysis.rules.prng_reuse import PrngReuseRule
from fed_tgan_torch.analysis.rules.recompile import RecompileRule
from fed_tgan_torch.analysis.rules.shared_state import SharedStateRule

ALL_RULES = (
    HostSyncRule(),
    PrngReuseRule(),
    RecompileRule(),
    NumpyInJitRule(),
    SharedStateRule(),
    DtypePromotionRule(),
    UnguardedFieldRule(),
    LockOrderRule(),
    BlockingUnderLockRule(),
    LockLeakRule(),
)

RULES_BY_ID = {r.rule_id: r for r in ALL_RULES}

__all__ = ["ALL_RULES", "RULES_BY_ID", "DtypePromotionRule", "HostSyncRule",
           "NumpyInJitRule", "PrngReuseRule", "RecompileRule",
           "SharedStateRule", "UnguardedFieldRule", "LockOrderRule",
           "BlockingUnderLockRule", "LockLeakRule"]
