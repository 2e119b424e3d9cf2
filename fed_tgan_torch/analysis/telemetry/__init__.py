"""obslint -- the telemetry-contract analysis prong (counterpart of
``fed_tgan_tpu/analysis/telemetry/``).

Beside locklint (concurrency, L01-L04), obslint checks the telemetry
contracts (O01-O05).  The static prong cross-checks
every journal emit site, metric get-or-create site, obs consumer read,
budget selector, and fault-spec reference against the checked-in
registry ``fed_tgan_torch/obs/schema.json``; the runtime prong is the
``validate=True`` mode on :class:`fed_tgan_torch.obs.journal.RunJournal`.

CLI: ``python -m fed_tgan_torch.analysis --telemetry [--schema-update]``.
"""

from fed_tgan_torch.analysis.telemetry.extract import Extraction, extract_repo
from fed_tgan_torch.analysis.telemetry.rules import (
    RULE_IDS,
    RULE_TITLES,
    run_telemetry,
)
from fed_tgan_torch.analysis.telemetry.schema import (
    DEFAULT_SCHEMA_PATH,
    generate_schema,
    load_schema,
    save_schema,
)

__all__ = [
    "DEFAULT_SCHEMA_PATH",
    "Extraction",
    "RULE_IDS",
    "RULE_TITLES",
    "extract_repo",
    "generate_schema",
    "load_schema",
    "run_telemetry",
    "save_schema",
]
