"""Test-time metric and artifact recording; counterpart of
``infinicube_tpu/training/test_recorder.py``: per-sample metrics collect
into a CSV with a mean row, and artifacts (grids, renders, gaussians) are
pickled beside it."""

from __future__ import annotations

import csv
import pickle
from pathlib import Path


class TestRecorder:
    def __init__(self, record_dir: str | Path):
        self.dir = Path(record_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.rows: list[dict] = []

    def record(self, sample_name: str, metrics: dict,
               artifacts: dict | None = None):
        row = {"name": sample_name}
        row.update({k: float(v) for k, v in metrics.items()})
        self.rows.append(row)
        for key, obj in (artifacts or {}).items():
            with open(self.dir / f"{sample_name}.{key}.pkl", "wb") as f:
                pickle.dump(obj, f)

    def finalize(self) -> dict:
        """Write metrics.csv (+ a mean row) and return the means."""
        if not self.rows:
            return {}
        keys = [k for k in self.rows[0] if k != "name"]
        means = {k: sum(r[k] for r in self.rows) / len(self.rows)
                 for k in keys}
        with open(self.dir / "metrics.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["name"] + keys)
            w.writeheader()
            for r in self.rows:
                w.writerow(r)
            w.writerow({"name": "MEAN", **{k: round(v, 6)
                                           for k, v in means.items()}})
        return means
