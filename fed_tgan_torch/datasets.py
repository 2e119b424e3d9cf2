"""Known-dataset presets (copy of ``fed_tgan_tpu/datasets.py:13-93``).

The schemas are plain data: the columns a run synthesizes, which of them
are categorical, which get ``log(x + 1)``, the target and problem type.
No preset has a date column, so the presets carry no date formats.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DatasetPreset:
    name: str
    selected_columns: tuple
    categorical_columns: tuple
    non_negative_columns: tuple = ()
    target_column: str = ""
    problem_type: str = ""


INTRUSION_SELECTED = (
    "duration", "protocol_type", "service", "flag", "src_bytes",
    "dst_bytes", "land", "wrong_fragment", "urgent", "hot",
    "num_failed_logins", "logged_in", "num_compromised", "root_shell",
    "su_attempted", "num_root", "num_file_creations", "num_shells",
    "num_access_files", "num_outbound_cmds", "is_host_login",
    "is_guest_login", "count", "srv_count", "serror_rate",
    "srv_serror_rate", "rerror_rate", "srv_rerror_rate", "same_srv_rate",
    "diff_srv_rate", "srv_diff_host_rate", "dst_host_count",
    "dst_host_srv_count", "dst_host_same_srv_rate",
    "dst_host_diff_srv_rate", "dst_host_same_src_port_rate",
    "dst_host_srv_diff_host_rate", "dst_host_serror_rate",
    "dst_host_srv_serror_rate", "dst_host_rerror_rate",
    "dst_host_srv_rerror_rate", "class",
)

INTRUSION_CATEGORICAL = (
    "protocol_type", "service", "flag", "land", "wrong_fragment", "urgent",
    "hot", "num_failed_logins", "logged_in", "num_compromised", "root_shell",
    "su_attempted", "num_root", "num_file_creations", "num_shells",
    "num_access_files", "num_outbound_cmds", "is_host_login",
    "is_guest_login", "class",
)

INTRUSION = DatasetPreset(
    name="Intrusion",
    selected_columns=INTRUSION_SELECTED,
    categorical_columns=INTRUSION_CATEGORICAL,
    non_negative_columns=("dst_bytes", "src_bytes"),
    target_column="class",
    problem_type="binary_classification",
)

ADULT = DatasetPreset(
    name="Adult",
    selected_columns=(
        "age", "workclass", "fnlwgt", "education", "education-num",
        "marital-status", "occupation", "relationship", "race", "sex",
        "capital-gain", "capital-loss", "hours-per-week", "native-country",
        "income",
    ),
    categorical_columns=(
        "workclass", "education", "marital-status", "occupation",
        "relationship", "race", "sex", "native-country", "income",
    ),
    non_negative_columns=("capital-gain", "capital-loss", "fnlwgt"),
    target_column="income",
    problem_type="binary_classification",
)

COVERTYPE = DatasetPreset(
    name="Covertype",
    selected_columns=(),  # all columns
    categorical_columns=("Cover_Type",),
    target_column="Cover_Type",
    problem_type="multiclass_classification",
)

PRESETS = {"intrusion": INTRUSION, "adult": ADULT, "covertype": COVERTYPE}


def preprocessor_kwargs(preset: DatasetPreset) -> dict:
    return dict(
        categorical_columns=list(preset.categorical_columns),
        non_negative_columns=list(preset.non_negative_columns),
        target_column=preset.target_column,
        problem_type=preset.problem_type,
        selected_columns=list(preset.selected_columns) or None,
    )
