"""J04 -- host ``numpy`` applied to a device tensor (counterpart of
``fed_tgan_tpu/analysis/rules/numpy_in_jit.py``).

Under JAX, ``np.*`` on a tracer crashes or bakes a stale constant into
the program.  Its torch counterpart: ``np.asarray(t)``, ``np.mean(t)``
... on a tensor on the device either copies and syncs through
``__array__`` behind the caller's back or, on a CUDA tensor, raises
``TypeError`` -- a crash the CPU tests never see.  Copy explicitly
(``t.cpu().numpy()``) or stay in torch.  Inside a hot loop the same call
is J01's finding.
"""

from __future__ import annotations

from typing import Iterator

from fed_tgan_torch.analysis.rules.base import scan, unique

RULE_ID = "J04"
HINT = ("on a device tensor use torch ops, or copy it explicitly first "
        "(t.cpu().numpy(), once, inside `with sanctioned_sync():`)")


class NumpyInJitRule:
    rule_id = RULE_ID
    title = "numpy on a device tensor"
    hint = HINT

    def check(self, mod) -> Iterator:
        rows = [(ln, msg) for ln, msg, hot in scan(mod).numpy if not hot]
        for line, message in unique(rows):
            yield (self.rule_id, line, message, self.hint)
