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
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        rec = {"step": int(step), "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self) -> None:
        self._f.close()
