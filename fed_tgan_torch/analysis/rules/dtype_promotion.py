"""J06 -- float64 requested on the device (counterpart of
``fed_tgan_tpu/analysis/rules/dtype_promotion.py``).

The card runs float64 at a small fraction of its float32 rate and at
twice the bytes; the port's programs are float32 (bf16 under mixed
precision) with no f64 op on the device (the program contracts' dtype
census is this rule's runtime twin).  Flagged:

* ``.double()``, ``.to(torch.float64)`` / ``.to(dtype=torch.float64)`` /
  ``.type(torch.float64)`` of a device tensor;
* a ``torch.*`` call with ``dtype=torch.float64`` (``torch.double``,
  ``float``, ``"float64"``) that lands on the device (a ``device=`` other
  than ``"cpu"``, or a device tensor argument);
* ``torch.as_tensor``/``torch.tensor`` of a float64 numpy array (numpy's
  default for ``np.zeros``, ``np.array`` of floats, ``np.random`` ...)
  with a device and no ``dtype=``, and ``torch.from_numpy`` of one moved
  with ``.to(device)``/``.cuda()`` and no dtype;
* an ``np.float64`` scalar combined with a device tensor.

float64 on the host (the zoo's numpy mirror, the host digamma) is not
flagged: it never reaches the card.
"""

from __future__ import annotations

from typing import Iterator

from fed_tgan_torch.analysis.rules.base import scan, unique

RULE_ID = "J06"
HINT = ("keep device tensors float32 (bf16 under mixed precision): give "
        "torch.as_tensor/.to() an explicit dtype=torch.float32 for numpy "
        "data, and do float64 work on the host")


class DtypePromotionRule:
    rule_id = RULE_ID
    title = "float64 on the device"
    hint = HINT

    def check(self, mod) -> Iterator:
        for line, message in unique(scan(mod).f64):
            yield (self.rule_id, line, message, self.hint)
