"""Logging and results (counterpart of ``quantized_tpu/utils/logging_utils.py``:
``setup_logging`` and ``ResultsLog``).

``ResultsLog`` keeps the reference's CSV contract and adds a JSONL line per
row; the reference's HTML plots become PNG figures (where matplotlib is
installed) and a self-contained HTML table. It writes the CSV with the
standard library, so it needs no pandas: the GPU machine has none."""

from __future__ import annotations

import csv
import html
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional


def setup_logging(log_file: str = "log.txt", level=logging.INFO) -> None:
    """File and console logging (the reference's ``setup_logging``)."""
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=[logging.FileHandler(log_file), logging.StreamHandler()],
        force=True,
    )


class ResultsLog:
    """Accumulate per-epoch rows; persist CSV (and JSONL) and render plots
    and an HTML table. The reference's API: ``add(**kwargs)``,
    ``plot(x, y, ...)``, ``save(title)``."""

    def __init__(self, path: str = "results.csv", plot_path: Optional[str] = None):
        self.path = path
        self.plot_path = plot_path or (os.path.splitext(path)[0] + ".html")
        self.jsonl_path = os.path.splitext(path)[0] + ".jsonl"
        self.rows: List[Dict[str, Any]] = []
        self._figures: List[Dict[str, Any]] = []

    @property
    def columns(self) -> List[str]:
        cols: List[str] = []
        for row in self.rows:
            cols.extend(k for k in row if k not in cols)
        return cols

    def add(self, **kwargs):
        self.rows.append(dict(kwargs))
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **{k: _jsonable(v) for k, v in kwargs.items()}}) + "\n")

    def plot(self, x: str, y, title: Optional[str] = None, ylabel: Optional[str] = None, **_):
        ys = [y] if isinstance(y, str) else list(y)
        self._figures.append({"x": x, "y": ys, "title": title or ",".join(ys), "ylabel": ylabel})

    def save(self, title: str = "results"):
        cols = self.columns
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=cols)
            writer.writeheader()
            writer.writerows(self.rows)
        page = [f"<html><head><title>{html.escape(title)}</title></head><body><h1>{html.escape(title)}</h1>"]
        page.extend(self._figure_tags())
        page.append("<table border=\"1\"><tr>" + "".join(f"<th>{html.escape(c)}</th>" for c in cols) + "</tr>")
        for row in self.rows:
            page.append("<tr>" + "".join(f"<td>{html.escape(str(row.get(c, '')))}</td>" for c in cols) + "</tr>")
        page.append("</table></body></html>")
        with open(self.plot_path, "w") as f:
            f.write("\n".join(page))

    def _figure_tags(self) -> List[str]:
        if not self._figures:
            return []
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return ["<p>plots unavailable: matplotlib is not installed</p>"]
        tags = []
        for i, fig in enumerate(self._figures):
            f, ax = plt.subplots(figsize=(6, 4))
            xs = [row.get(fig["x"]) for row in self.rows]
            for col in fig["y"]:
                ax.plot(xs, [row.get(col) for row in self.rows], label=col)
            ax.set_xlabel(fig["x"])
            if fig["ylabel"]:
                ax.set_ylabel(fig["ylabel"])
            ax.legend()
            ax.set_title(fig["title"])
            png = os.path.splitext(self.path)[0] + f"_fig{i}.png"
            f.savefig(png, dpi=80)
            plt.close(f)
            tags.append(f'<img src="{os.path.basename(png)}"/>')
        return tags


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return float(v) if hasattr(v, "__float__") else str(v)
