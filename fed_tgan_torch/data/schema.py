"""Table metadata model (copy of ``fed_tgan_tpu/data/schema.py``).

``TableMeta`` round-trips the reference meta JSON, "continous" spelling
included, so the port reads the meta files the JAX package writes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from fed_tgan_torch.data.constants import (
    CATEGORICAL,
    CONTINUOUS,
    CONTINUOUS_JSON,
    ORDINAL,
    is_continuous_kind,
)


def _jsonable(obj: Any) -> Any:
    """numpy scalars/arrays -> plain Python for json.dump."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


@dataclass
class ColumnMeta:
    name: str
    kind: str  # CATEGORICAL / CONTINUOUS / ORDINAL
    index: int
    # categorical: a frequency dict (local meta) or an ordered list (global
    # meta).  Continuous: None.
    i2s: Optional[Any] = None
    min: Optional[float] = None
    max: Optional[float] = None

    @property
    def size(self) -> Optional[int]:
        return None if self.i2s is None else len(self.i2s)

    @property
    def is_continuous(self) -> bool:
        return is_continuous_kind(self.kind)

    def to_json_dict(self) -> dict:
        d: dict = {"column_name": self.name, "column no": self.index}
        if self.kind in (CATEGORICAL, ORDINAL):
            d["type"] = self.kind
            d["size"] = self.size
            d["i2s"] = _jsonable(self.i2s)
        else:
            d["type"] = CONTINUOUS_JSON  # reference spelling
            d["min"] = _jsonable(self.min)
            d["max"] = _jsonable(self.max)
        return d

    @classmethod
    def from_json_dict(cls, d: dict, index: int) -> "ColumnMeta":
        kind = d["type"]
        if is_continuous_kind(kind):
            return cls(name=d["column_name"], kind=CONTINUOUS,
                       index=d.get("column no", index),
                       min=d.get("min"), max=d.get("max"))
        return cls(name=d["column_name"], kind=kind,
                   index=d.get("column no", index), i2s=d.get("i2s"))


@dataclass
class TableMeta:
    """Full dataset meta (the reference's meta JSON top level)."""

    columns: list[ColumnMeta]
    name: str = ""
    problem_type: str = ""
    target: Optional[str] = None
    date_info: dict = field(default_factory=dict)
    integer_columns: list = field(default_factory=list)
    non_negative_columns: list = field(default_factory=list)

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    @property
    def categorical_columns(self) -> list[str]:
        return [c.name for c in self.columns if c.kind == CATEGORICAL]

    @property
    def continuous_columns(self) -> list[str]:
        return [c.name for c in self.columns if c.is_continuous]

    def to_json_dict(self) -> dict:
        d = {
            "columns": [c.to_json_dict() for c in self.columns],
            "problem_type": self.problem_type,
            "name": self.name,
            "date_info": _jsonable(self.date_info),
            "integer_info": _jsonable(list(self.integer_columns)),
            "non_negative_cols": _jsonable(list(self.non_negative_columns)),
        }
        if self.target:
            d["target"] = self.target
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "TableMeta":
        return cls(
            columns=[ColumnMeta.from_json_dict(c, i)
                     for i, c in enumerate(d["columns"])],
            name=d.get("name", ""),
            problem_type=d.get("problem_type", ""),
            target=d.get("target"),
            date_info=d.get("date_info", {}),
            integer_columns=d.get("integer_info", []),
            non_negative_columns=d.get("non_negative_cols", []),
        )

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, sort_keys=True, indent=4,
                      separators=(",", ": "))

    @classmethod
    def load_json(cls, path: str) -> "TableMeta":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))
