"""Minimal ASCII table (port of mmgclip_tpu/utils/table.py; replaces the
reference's prettytable dependency)."""

from __future__ import annotations

from typing import Any, List, Sequence


class Table:
    def __init__(self, field_names: Sequence[str]):
        self.field_names = list(field_names)
        self.rows: List[List[Any]] = []

    def add_row(self, row: Sequence[Any]) -> None:
        self.rows.append(list(row))

    def __str__(self) -> str:
        def fmt(value: Any) -> str:
            if isinstance(value, float):
                return f"{value:.6g}"
            return str(value)

        cells = [self.field_names] + [[fmt(v) for v in row] for row in self.rows]
        widths = [max(len(row[i]) for row in cells) for i in range(len(self.field_names))]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        lines = [sep]
        for idx, row in enumerate(cells):
            lines.append("| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |")
            if idx == 0:
                lines.append(sep)
        lines.append(sep)
        return "\n".join(lines)
