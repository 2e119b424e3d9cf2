"""obslint O03 bad twin: metric-name drift and cardinality hazards.

Never imported -- parsed by the analyzer only.
"""
from fed_tgan_torch.obs.registry import counter as _metric_counter
from fed_tgan_torch.obs.registry import get_registry


def series(i):
    reg = get_registry()
    _metric_counter("fx_rogue_total").inc()  # EXPECT: O03
    reg.gauge("fx_rounds_total").set(i)  # EXPECT: O03
    reg.gauge("fx_weight", labels={"shard": "s0"})  # EXPECT: O03
    reg.gauge("fx_weight", labels={"client": str(i)})  # EXPECT: O03
