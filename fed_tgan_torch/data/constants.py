"""Column-kind constants (copy of ``fed_tgan_tpu/data/constants.py``).

The reference meta JSON spells the continuous kind "continous" (sic); both
spellings are accepted on input and the misspelled one is emitted.
"""

CATEGORICAL = "categorical"
CONTINUOUS = "continuous"
ORDINAL = "ordinal"

# The misspelled kind tag used inside reference meta JSON files.
CONTINUOUS_JSON = "continous"

MISSING_TOKEN = "empty"

# Sentinel for missing values in continuous columns: np.exp(-999999) - 1
# gives -1, which the non-negative decode maps back to a blank cell.
MISSING_CONTINUOUS = -999999.0


def is_continuous_kind(kind: str) -> bool:
    return kind in (CONTINUOUS, CONTINUOUS_JSON)
