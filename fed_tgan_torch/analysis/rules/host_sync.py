"""J01 -- a blocking device->host sync inside a hot loop (counterpart of
``fed_tgan_tpu/analysis/rules/host_sync.py``).

A sink is a per-iteration host read of a device tensor (see
:mod:`.base` for what is tainted): ``.item()``, ``float()``/``int()``/
``bool()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` or an ``np.*`` call,
lexically inside a ``for``/``while``/comprehension or inside a function
called from one (one hop per sweep, enough for helpers of helpers).

The designed idiom is not flagged: the port's one batched host copy per
chunk or response runs inside ``with sanctioned_sync():`` (or through a
``_to_host`` helper), and its result is host data, so post-copy numpy
stays clean.  ``np.*`` on a device tensor outside a hot loop is J04's.
"""

from __future__ import annotations

from typing import Iterator

from fed_tgan_torch.analysis.rules.base import scan, unique

RULE_ID = "J01"
HINT = ("keep the loop on the device and copy once: stack what the loop "
        "needs and read it in one .cpu() inside `with sanctioned_sync():` "
        "after the loop (or per chunk)")


class HostSyncRule:
    rule_id = RULE_ID
    title = "host sync in hot path"
    hint = HINT

    def check(self, mod) -> Iterator:
        ev = scan(mod)
        rows = list(ev.syncs) + [(ln, msg) for ln, msg, hot in ev.numpy
                                 if hot]
        for line, message in unique(rows):
            yield (self.rule_id, line, message, self.hint)
