"""Minimal PrettyTable-compatible ASCII table (port of
``cvcs_tpu/utils/tables.py``).

The reference renders configs, class weights and metric reports with
``prettytable``. Where that package is importable it is used
(:func:`get_table_cls`); otherwise :class:`AsciiTable` renders the same
subset: a constructor with field names, ``add_row``, ``align`` and
``str()`` with +-| borders.
"""

from __future__ import annotations


class AsciiTable:
    """Drop-in subset of ``prettytable.PrettyTable``."""

    def __init__(self, field_names: list[str]):
        self.field_names = list(field_names)
        self.rows: list[list] = []
        self.align = "c"  # "l" | "c" | "r" (applied to all columns)

    def add_row(self, row: list) -> None:
        if len(row) != len(self.field_names):
            raise ValueError(
                f"row has {len(row)} values, expected {len(self.field_names)}")
        self.rows.append(list(row))

    def _fmt(self, value, width: int) -> str:
        s = str(value)
        if self.align == "l":
            return s.ljust(width)
        if self.align == "r":
            return s.rjust(width)
        return s.center(width)

    def __str__(self) -> str:
        cells = [[str(v) for v in row] for row in self.rows]
        widths = [
            max([len(name)] + [len(r[i]) for r in cells])
            for i, name in enumerate(self.field_names)
        ]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = [sep]
        out.append("| " + " | ".join(
            str(n).center(w) for n, w in zip(self.field_names, widths)) + " |")
        out.append(sep)
        for row in cells:
            out.append("| " + " | ".join(
                self._fmt(v, w) for v, w in zip(row, widths)) + " |")
        out.append(sep)
        return "\n".join(out)


def get_table_cls():
    """``prettytable.PrettyTable`` when available, else :class:`AsciiTable`."""
    try:
        from prettytable import PrettyTable
        return PrettyTable
    except ImportError:
        return AsciiTable
