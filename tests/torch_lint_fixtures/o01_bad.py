"""obslint O01 bad twin: emit sites that break the event registry.

Never imported -- parsed by the analyzer only.  ``# EXPECT: OXX`` marks
the lines the rules must flag (checked by tests/test_torch_obslint.py
against the fixture registry ``obslint_schema.json``).
"""
from fed_tgan_torch.obs.journal import emit as _emit_event


def tick(i):
    _emit_event("phantom_event", value=i)  # EXPECT: O01
    _emit_event("round", last=i)  # EXPECT: O01
    _emit_event("round", first=i, per_round_s=0.5, last=i)


class Keeper:
    """The port's event-keeping wrappers: the same contract."""

    def tick(self, i):
        self._event("round", last=i)  # EXPECT: O01
        self._emit({"type": "phantom_event", "value": i})  # EXPECT: O01
        self._emit({"type": "round", "last": i})  # EXPECT: O01
        self._emit({"type": "round", "first": i, "per_round_s": 0.5})

    def _event(self, type, **fields):
        _emit_event(type, **fields)

    def _emit(self, event):
        _emit_event(**event)
