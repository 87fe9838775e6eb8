"""Run-statistics table mimicking deal.II's ConvergenceTable output.

The reference accumulates one row per JSON config and prints a text table
after each config and at the end (reference ``main.cc:3756-3761``).  Same
here: ``add_value`` fills the current row; ``commit_row`` closes it.
"""

from __future__ import annotations


class ConvergenceTable:
    def __init__(self) -> None:
        self.columns: list[str] = []
        self.scientific: set[str] = set()
        self.rows: list[dict] = []
        self._current: dict = {}

    def add_value(self, column: str, value) -> None:
        if column not in self.columns:
            self.columns.append(column)
        self._current[column] = value

    def set_scientific(self, column: str, flag: bool = True) -> None:
        if flag:
            self.scientific.add(column)

    def commit_row(self) -> None:
        self.rows.append(self._current)
        self._current = {}

    def _fmt(self, column: str, value) -> str:
        if value is None:
            return "-"
        if column in self.scientific:
            return f"{float(value):.4e}"
        if isinstance(value, float):
            return f"{value:.4g}"
        return str(value)

    def to_string(self) -> str:
        rows = self.rows + ([self._current] if self._current else [])
        cells = [
            [self._fmt(c, r.get(c)) for c in self.columns] for r in rows
        ]
        widths = [
            max(len(c), *(len(row[i]) for row in cells)) if cells else len(c)
            for i, c in enumerate(self.columns)
        ]
        lines = [
            " ".join(c.rjust(w) for c, w in zip(self.columns, widths))
        ]
        for row in cells:
            lines.append(" ".join(v.rjust(w) for v, w in zip(row, widths)))
        return "\n".join(lines)
