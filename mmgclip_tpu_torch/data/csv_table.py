"""CSV tables without pandas (the card's machine has none).

``read_csv`` reads a file as ``pandas.read_csv(path, dtype=str)`` does, with
or without ``index_col=0`` (pandas 3.0.3 is the reference): every value a
string, and pandas' default NA strings (an empty cell, ``NA``, ``nan``,
``NULL``, ``None`` and the rest of ``NA_VALUES``) read as missing, which is
``None`` here (pandas 3 gives ``nan`` in its string dtype).  Blank lines are
skipped.  ``write_csv`` writes what ``DataFrame.to_csv`` / ``Series.to_csv``
write: the index column under an empty header, minimal quoting with ``"``,
``\\n`` line ends, missing values as empty cells.

A ``Table`` is a list of plain dict rows with its column order and its index
labels, which filtering keeps (as a DataFrame's boolean mask does) until
``reset_index``.
"""

from __future__ import annotations

import csv
import io
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

# pandas._libs.parsers.STR_NA_VALUES (pandas 3.0.3)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def is_missing(value: Any) -> bool:
    """``None`` or a float NaN (what pandas writes as an empty cell)."""
    return value is None or (isinstance(value, float) and math.isnan(value))


@dataclass
class Table:
    columns: List[str]
    rows: List[Dict[str, Any]]
    index: List[Any] = field(default=None)
    index_name: Optional[str] = None

    def __post_init__(self):
        if self.index is None:
            self.index = list(range(len(self.rows)))
        if len(self.index) != len(self.rows):
            raise ValueError(f"{len(self.index)} index labels for {len(self.rows)} rows")

    @classmethod
    def from_rows(cls, rows: Sequence[Dict[str, Any]], columns: Optional[Sequence[str]] = None):
        """Rows as they are (copied), columns in the first row's key order."""
        rows = [dict(row) for row in rows]
        if columns is None:
            columns = list(rows[0]) if rows else []
        return cls(list(columns), rows)

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> List[Any]:
        return [row[name] for row in self.rows]

    def select(self, keep: Iterable[bool]) -> "Table":
        """Rows where ``keep`` is true, with their index labels."""
        pairs = [(label, row) for label, row, k in zip(self.index, self.rows, keep) if k]
        return Table(list(self.columns), [row for _label, row in pairs],
                     [label for label, _row in pairs], self.index_name)

    def reset_index(self) -> "Table":
        return Table(list(self.columns), self.rows, None, None)

    def copy(self) -> "Table":
        return Table(list(self.columns), [dict(row) for row in self.rows], list(self.index),
                     self.index_name)

    def set_column(self, name: str, values: Iterable[Any]) -> None:
        """Overwrite a column or append a new one after the last."""
        values = list(values)
        if len(values) != len(self.rows):
            raise ValueError(f"column {name!r}: {len(values)} values for {len(self.rows)} rows")
        if name not in self.columns:
            self.columns.append(name)
        for row, value in zip(self.rows, values):
            row[name] = value

    def drop_column(self, name: str) -> None:
        self.columns.remove(name)
        for row in self.rows:
            del row[name]

    def rename(self, mapping: Dict[str, str]) -> "Table":
        columns = [mapping.get(c, c) for c in self.columns]
        if len(set(columns)) != len(columns):  # a DataFrame would hold both; dict rows cannot
            raise ValueError(f"renaming {mapping} duplicates a column of {self.columns}")
        rows = [{mapping.get(k, k): v for k, v in row.items()} for row in self.rows]
        return Table(columns, rows, list(self.index), self.index_name)


def read_csv(path: str, *, encoding: str = "utf-8", index_col: Optional[int] = None,
             sep: str = ",", names: Optional[Sequence[str]] = None) -> Table:
    """``pandas.read_csv(path, dtype=str, sep=sep, index_col=index_col,
    names=names, encoding=encoding)``: the first line is the header unless
    ``names`` is given."""
    with open(path, "rb") as fh:
        text = fh.read().decode(encoding)
    if encoding.replace("-", "").replace("_", "").lower() == "utf8" and text.startswith("\ufeff"):
        text = text[1:]
    records = [r for r in csv.reader(io.StringIO(text, newline=""), delimiter=sep, quotechar='"',
                                     doublequote=True, strict=False) if r]
    if names is None:
        if not records:
            raise ValueError(f"{path}: no columns to parse")
        header, records = records[0], records[1:]
    else:
        header = list(names)
    width = len(header)
    index, index_name = None, None
    if index_col is not None:
        if index_col != 0:
            raise ValueError("only index_col=0 is supported")
        index_name = header[0] or None
        header = header[1:]
    rows, labels = [], []
    for record in records:
        if len(record) > width:
            raise ValueError(f"{path}: a row has {len(record)} fields, the header {width}")
        values = [None if v in NA_VALUES else v for v in record] + [None] * (width - len(record))
        if index_col is not None:
            labels.append(values[0])
            values = values[1:]
        rows.append(dict(zip(header, values)))
    if index_col is not None:
        index = labels
    return Table(list(header), rows, index, index_name)


def _cell(value: Any) -> str:
    if is_missing(value):
        return ""
    if isinstance(value, float):
        return repr(value)
    return str(value)


def write_csv(path: str, table: Table, *, index: bool = True, header: bool = True,
              sep: str = ",", encoding: str = "utf-8", mode: str = "w") -> None:
    """``DataFrame.to_csv(path, sep=sep, index=index, header=header,
    encoding=encoding, mode=mode)`` of ``table``."""
    columns = table.columns
    with open(path, mode, encoding=encoding, newline="") as fh:
        writer = csv.writer(fh, delimiter=sep, quotechar='"', doublequote=True,
                            quoting=csv.QUOTE_MINIMAL, lineterminator="\n")
        if header:
            writer.writerow(([_cell(table.index_name)] if index else []) + columns)
        for label, row in zip(table.index, table.rows):
            cells = [_cell(row[c]) for c in columns]
            writer.writerow(([_cell(label)] if index else []) + cells)


def append_text_column(path: str, values: Iterable[Any]) -> None:
    """``series.to_csv(path, index=False, header=False, sep=" ", mode="a")``:
    one value per line, quoted where the CSV dialect needs it."""
    write_csv(path, Table(["value"], [{"value": v} for v in values]), index=False, header=False,
              sep=" ", mode="a")
