"""CSV reading with schema inference (CSVAutoReaders.scala): a column
whose non-empty values all parse as booleans becomes Binary, as integers
Integral, as floats Real; otherwise Text. Empty strings are missing."""
from __future__ import annotations

import csv as _csv
from typing import Any, Iterable, Sequence

import numpy as np

from .. import types as T
from ..dataset import Dataset
from ..types.columns import NumericColumn, column_from_values
from .core import DataReader

_BOOL_TOKENS = {"true", "false", "t", "f", "yes", "no"}


def _infer_type(values: Iterable[str | None]) -> type:
    saw_any = False
    is_bool = is_int = is_float = True
    for v in values:
        if v is None or v == "":
            continue
        saw_any = True
        s = v.strip()
        if is_bool and s.lower() not in _BOOL_TOKENS:
            is_bool = False
        if is_int:
            try:
                int(s)
            except ValueError:
                is_int = False
        if not is_int and is_float:
            try:
                float(s)
            except ValueError:
                is_float = False
        if not (is_bool or is_int or is_float):
            return T.Text
    if not saw_any:
        return T.Text
    if is_bool:
        return T.Binary
    if is_int:
        return T.Integral
    if is_float:
        return T.Real
    return T.Text


def _read_table(
    path: str,
    headers: Sequence[str] | None,
    has_header: bool | None,
) -> tuple[list[str], list[list[str]]]:
    """(column names, body rows). Physically blank lines are skipped; a
    short row's missing trailing cells are empty."""
    with open(path, newline="", encoding="utf-8") as fh:
        rows = [r for r in _csv.reader(fh) if r]
    if not rows:
        return [], []
    if has_header is None:
        has_header = headers is None
    if has_header:
        return rows[0], rows[1:]
    if headers is None:
        raise ValueError("headers required when the file has no header row")
    return list(headers), rows


def _cell(row: list[str], j: int) -> str | None:
    return (row[j] if j < len(row) else "") or None


def _parse_reals(vals: list[str | None]) -> NumericColumn:
    """An inferred Real column: one batch parse of the fields in native
    code (``native.parse_doubles``); the few fields ``strtod`` rejects but
    ``float`` accepts (Unicode digits, exotic whitespace) are parsed again
    with ``float``. A field that does not parse is missing."""
    from ..native import parse_doubles

    values, mask = parse_doubles(vals)
    for i in np.nonzero(~mask)[0]:
        v = vals[i]
        if v is not None and v.strip():
            try:
                values[i] = float(v)
                mask[i] = True
            except ValueError:
                pass
    return NumericColumn(T.Real, values, mask)


def infer_csv_dataset(
    path: str,
    headers: Sequence[str] | None = None,
    has_header: bool | None = None,
    type_overrides: dict[str, type] | None = None,
) -> Dataset:
    """Read a CSV into a typed columnar Dataset with inferred feature
    types (``type_overrides`` names a column's type outright)."""
    names, body = _read_table(path, headers, has_header)
    if not names:
        return Dataset({}, 0)
    columns = {}
    overrides = type_overrides or {}
    for j, name in enumerate(names):
        vals = [_cell(r, j) for r in body]
        ftype = overrides.get(name)
        if ftype is None:
            ftype = _infer_type(vals)
            if ftype is T.Real:
                columns[name] = _parse_reals(vals)
                continue
        columns[name] = column_from_values(ftype, vals)
    return Dataset.of(columns)


def read_csv_auto(path: str, **kwargs: Any) -> Dataset:
    return infer_csv_dataset(path, **kwargs)


class CsvReader(DataReader):
    """Record reader yielding one dict per CSV row (DataReaders.Simple.csv)."""

    def __init__(
        self,
        path: str,
        headers: Sequence[str] | None = None,
        has_header: bool | None = None,
        key_fn: Any = None,
    ):
        super().__init__(key_fn)
        self.path = path
        self.headers = headers
        self.has_header = has_header

    def read_records(self) -> Iterable[dict[str, str | None]]:
        names, body = _read_table(self.path, self.headers, self.has_header)
        return [{n: _cell(r, j) for j, n in enumerate(names)} for r in body]
