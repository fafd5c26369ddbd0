"""Training metrics: one JSON line per record in ``exp/<run>/metrics.jsonl``.

Port of ``diffwave_sashimi_tpu/runtime/metrics.py::MetricsLogger`` with the
same keys (``train/loss``, ``train/log_loss``, ``train/steps_per_sec``,
``train/loss_epoch``); the wandb mirror is not ported (the trainer refuses
a config that enables it).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    """``enabled=False`` (a rank other than 0) writes nothing."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self) -> None:
        if self._f is not None:
            self._f.close()
