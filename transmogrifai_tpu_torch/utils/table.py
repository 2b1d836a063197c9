"""ASCII table rendering (reference: utils/.../table/Table.scala:156)."""
from __future__ import annotations

from typing import Sequence


def render_table(headers: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    cols = [[str(h)] + [str(r[i]) for r in rows] for i, h in enumerate(headers)]
    widths = [max(len(v) for v in col) for col in cols]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(cells: Sequence[str]) -> str:
        return "|" + "|".join(
            f" {str(c):<{w}} " for c, w in zip(cells, widths)
        ) + "|"

    out = [sep, fmt(headers), sep]
    out += [fmt([str(c) for c in r]) for r in rows]
    out.append(sep)
    return "\n".join(out)
