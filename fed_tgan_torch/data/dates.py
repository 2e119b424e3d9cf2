"""Date columns split into categorical part-columns and rejoined
(counterpart of ``fed_tgan_tpu/data/dates.py:22-145``, on column dicts
with the stdlib ``datetime`` instead of pandas).

A date column declared as e.g. ``{"when": "YYYY-MM-DD"}`` or
``{"stamp": "yymmdd|YYYY-MM-DD"}`` (origin format ``|`` part format) is
parsed and replaced by categorical part-columns (``when-year``,
``when-month``, ``when-day``) appended after every other column; on
decode the parts are rejoined into the date column, which then comes
after every other column.  The behaviour is the JAX package's:

- the Gregorian leap-year rule;
- a day past its month's end clamped to 30, or in February to the
  month's last day;
- ``YYYY`` written as the 2-digit ``%y`` part (``%y`` reads 00-68 as
  20xx, as pandas does);
- the missing token ``'empty'`` in any part makes the date missing;
- a rejoined date is a ``datetime`` at midnight (written
  ``2024-02-29 00:00:00``, as pandas writes a ``Timestamp``), a
  ``yymmdd`` one the int of its ``%y%m%d`` digits (years 2000-2009 lose
  the leading zero).

Parsing differs where pandas infers a format: a non-``yymmdd`` column
takes ISO 8601 (``datetime.fromisoformat``), ``%Y/%m/%d`` and
``%m/%d/%Y``; any other value raises ``ValueError`` naming the column
and the value (ROADMAP §C lists this divergence).
"""

from __future__ import annotations

import datetime as dt

import numpy as np

from fed_tgan_torch.data.constants import MISSING_TOKEN

# part-name suffix and strftime code per format token
_PART_SUFFIX = {"YYYY": "-year", "MM": "-month", "DD": "-day",
                "hh": "-hour", "mm": "-minute", "ss": "-second"}
_PART_STRFTIME = {"YYYY": "%y", "MM": "%m", "DD": "%d",
                  "hh": "%H", "mm": "%M", "ss": "%S"}
_DAYS_IN_MONTH = {1: 31, 2: 28, 3: 31, 4: 30, 5: 31, 6: 30, 7: 31, 8: 31,
                  9: 30, 10: 31, 11: 30, 12: 31}
_FALLBACK_FORMATS = ("%Y/%m/%d", "%m/%d/%Y")


def _parse_format(fmt: str) -> tuple:
    """``"origin|PARTS"`` -> (origin format or None, part format)."""
    pieces = fmt.split("|")
    if len(pieces) == 2:
        return pieces[0], pieces[1]
    return None, pieces[0]


def part_columns(column: str, fmt: str) -> list:
    _, d_format = _parse_format(fmt)
    return [column + _PART_SUFFIX[tok] for tok in d_format.split("-")]


def _is_missing(v) -> bool:
    return (v is None or (isinstance(v, float) and v != v)
            or str(v) == MISSING_TOKEN)


def _parse(column: str, value, yymmdd: bool) -> dt.datetime:
    if yymmdd:
        # numeric stamps, floats where the column had blanks: zero-padded
        # before parsing, since years 2000-2009 lost their leading zero
        return dt.datetime.strptime(str(int(float(value))).zfill(6),
                                    "%y%m%d")
    text = str(value)
    try:
        return dt.datetime.fromisoformat(text)
    except ValueError:
        pass
    for fmt in _FALLBACK_FORMATS:
        try:
            return dt.datetime.strptime(text, fmt)
        except ValueError:
            pass
    raise ValueError(f"date column {column!r}: cannot parse {text!r} (ISO "
                     f"8601, {' or '.join(_FALLBACK_FORMATS)} expected)")


def split_date_columns(table: dict, date_formats: dict,
                       categorical_list: list) -> dict:
    """``table`` with each declared date column replaced by its part
    columns (strings, the missing token where the date is missing),
    appended at the end.  ``categorical_list`` is edited in place as the
    JAX package does: the date column removed, its parts appended."""
    out = dict(table)
    for column, fmt in date_formats.items():
        if column in categorical_list:
            categorical_list.remove(column)
        o_format, d_format = _parse_format(fmt)
        raw = np.asarray(out.pop(column), dtype=object).tolist()
        parsed = [None if _is_missing(v)
                  else _parse(column, v, o_format == "yymmdd") for v in raw]
        for tok in d_format.split("-"):
            code = _PART_STRFTIME[tok]
            part = column + _PART_SUFFIX[tok]
            out[part] = np.array([MISSING_TOKEN if d is None
                                  else d.strftime(code) for d in parsed],
                                 dtype=object)
            categorical_list.append(part)
    return out


def _is_leap(year: int) -> bool:
    return (year % 4 == 0 and year % 100 != 0) or year % 400 == 0


def _rejoin(y: str, m: str, d: str) -> str:
    """``y-m-d`` of the year and month parts and the clamped day."""
    month, day = int(m), int(d)
    max_day = _DAYS_IN_MONTH[month]
    if month == 2 and _is_leap(2000 + int(y) % 100):
        max_day = 29
    if day > max_day:
        day = max_day if month == 2 else 30
    return "-".join([y, m, f"{day:02d}"])


def join_date_columns(cols: dict, date_formats: dict) -> dict:
    """``cols`` (part columns holding category strings) with each date's
    parts replaced by the rejoined date column, appended at the end: a
    ``datetime`` (an int for a ``yymmdd`` origin), or the missing token
    where any part holds it."""
    out = dict(cols)
    for column, fmt in date_formats.items():
        o_format, d_format = _parse_format(fmt)
        parts = part_columns(column, fmt)
        rows = list(zip(*(np.asarray(out.pop(p)).astype(str).tolist()
                          for p in parts)))
        suffixes = [p[len(column):] for p in parts]
        ymd = {"-year", "-month", "-day"} <= set(suffixes)
        pos = ([suffixes.index(s) for s in ("-year", "-month", "-day")]
               if ymd else None)
        joined = np.empty(len(rows), dtype=object)
        for i, row in enumerate(rows):
            if any(MISSING_TOKEN in s for s in row):
                joined[i] = MISSING_TOKEN
                continue
            text = (_rejoin(*(row[j] for j in pos)) if ymd
                    else "-".join(row))
            stamp = dt.datetime.strptime(text, "%y-%m-%d")
            joined[i] = (int(stamp.strftime("%y%m%d"))
                         if o_format == "yymmdd" else stamp)
        out[column] = joined
    return out
