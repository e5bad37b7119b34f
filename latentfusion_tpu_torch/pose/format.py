"""Metric tables as text (counterpart of ``latentfusion_tpu/pose/format.py``):
the same strings, character for character."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def simple_table(rows: List[List], headers: List[str]) -> str:
    """Left-justified columns two spaces apart, a dashed rule under the
    headers; floats with four decimals."""
    all_rows = [headers] + [[_fmt(c) for c in r] for r in rows]
    widths = [max(len(str(c)) for c in col) for col in zip(*all_rows)]
    lines = []
    for i, row in enumerate(all_rows):
        lines.append("  ".join(str(c).ljust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def metrics_table(metrics: Dict, name: str = "") -> str:
    """One estimate's metrics, one per row; ``rotation_dist`` in degrees."""
    rows = []
    for k, v in metrics.items():
        if k == "rotation_dist":
            v = v / math.pi * 180.0
            k = "rotation_dist (deg)"
        rows.append([k, float(np.asarray(v).reshape(()))])
    return (f"{name}\n" if name else "") + simple_table(rows, ["metric", "value"])


def metrics_table_multiple(metrics_list: List[Dict], names=None,
                           thresholds=(0.02, 0.05, 0.10)) -> str:
    """One row per estimate, a MEAN row, then for each threshold the share
    of estimates whose ADD, ADD-S or ADD-sym is below it."""
    if names is None:
        names = [str(i) for i in range(len(metrics_list))]
    keys = list(metrics_list[0].keys())
    rows = [[name] + [float(np.asarray(m[k]).reshape(())) for k in keys]
            for name, m in zip(names, metrics_list)]
    rows.append(["MEAN"] + [float(np.mean([r[i + 1] for r in rows]))
                            for i in range(len(keys))])
    lines = [simple_table(rows, ["name"] + keys)]
    for t in thresholds:
        acc = {k: float(np.mean([m[k] < t for m in metrics_list]))
               for k in keys if k in ("add", "add_s", "add_sym")}
        if acc:
            lines.append(f"accuracy @ {t:.2f}m: " + ", ".join(
                f"{k}={v:.3f}" for k, v in acc.items()))
    return "\n".join(lines)
