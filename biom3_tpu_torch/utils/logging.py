"""Metric logging to CSV.

The port's copy of ``biom3_tpu/utils/logging.py:20-79`` (``MetricLogger``)
without its optional TensorBoard writer (``torch.utils.tensorboard`` loads
TensorFlow where it is installed, seconds of start-up for a second copy of
the CSV).  One fault of the original is fixed: a resumed run's first new
metric name rewrote the CSV under a header that lacked the names of the
rows already in the file, and failed.

Replaces the reference's ~20 ``self.log(..., sync_dist=True)`` calls per step
(``Stage1_source/PL_wrapper.py:1092-1112``): metrics accumulate on device and
flush on a cadence, so logging never forces a host sync in the step loop.

The CSV is append-only — O(1) host work per ``log`` call.  The file is
rewritten only when the set of metric names grows (e.g. the first ``val_*``
row joining train rows), which happens a bounded number of times per run.
"""

from __future__ import annotations

import csv
import io
import os
from typing import Mapping


class MetricLogger:
    def __init__(self, log_dir: str, *, filename: str = "metrics.csv"):
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, filename)
        self._fieldnames: list[str] = ["step"]
        self._file: io.TextIOWrapper | None = None

    def _open_append(self) -> csv.DictWriter:
        self._file = open(self.csv_path, "a", newline="")
        self._writer = csv.DictWriter(
            self._file, fieldnames=self._fieldnames, restval=""
        )
        return self._writer

    def _rewrite_with_header(self) -> None:
        """Rewrite the CSV under a grown header union (rare: only when new
        metric names first appear).  Existing rows are re-emitted with blanks
        in the new columns."""
        if self._file is not None:
            self._file.close()
            self._file = None
        old_rows: list[dict] = []
        if os.path.exists(self.csv_path):
            with open(self.csv_path, newline="") as f:
                reader = csv.DictReader(f)
                old_rows = list(reader)
            self._fieldnames.extend(k for k in reader.fieldnames or ()
                                    if k not in self._fieldnames)
        with open(self.csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames, restval="")
            writer.writeheader()
            for row in old_rows:
                row.pop(None, None)
                writer.writerow(row)
        self._open_append()

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        values = {"step": step}
        values.update({k: float(v) for k, v in metrics.items()})
        new_names = [k for k in values if k not in self._fieldnames]
        if new_names or self._file is None:
            self._fieldnames.extend(new_names)
            self._rewrite_with_header()
        self._writer.writerow(values)
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
