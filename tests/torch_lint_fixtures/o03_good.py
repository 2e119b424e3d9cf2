"""obslint O03 good twin: catalogued names, kinds, bounded labels."""
from fed_tgan_torch.obs.registry import counter as _metric_counter
from fed_tgan_torch.obs.registry import get_registry

_LABEL_CAP = 64


def series(i, stage):
    reg = get_registry()
    _metric_counter("fx_rounds_total").inc()
    if i >= _LABEL_CAP:
        # the exempt idiom: per-client labels stay bounded by the cap
        return
    reg.gauge("fx_weight", labels={"client": str(i)})
    reg.histogram(f"fx_stage_{stage}", labels={"stage": stage})
