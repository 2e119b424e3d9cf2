"""obslint O01 good twin: every emit honors ``obslint_schema.json``."""
from fed_tgan_torch.obs.journal import emit as _emit_event


def tick(i, extra):
    _emit_event("round", first=i, per_round_s=0.5)
    _emit_event("round", first=i, per_round_s=0.5, rounds=1, last=i)
    # open event: emitters may attach any shape (splat stays unchecked)
    _emit_event("open_ev", **extra)


class Keeper:
    def tick(self, i):
        self._event("round", first=i, per_round_s=0.5)
        self._emit({"type": "round", "first": i, "per_round_s": 0.5,
                    "last": i})

    def _event(self, type, **fields):
        _emit_event(type, **fields)

    def _emit(self, event):
        _emit_event(**event)
