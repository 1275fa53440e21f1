"""Per-run metric stream.

Counterpart of ``sgp_tpu/obs/run_logger.py``: metric dicts appended as JSON
lines to ``metrics.jsonl`` in the run's log directory (each with ``_time``
and, when given, ``_step``), and text artifacts written beside it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class RunLogger:
    def __init__(self, logdir: str, prefix: str = ""):
        self.logdir = logdir
        self.prefix = prefix
        os.makedirs(logdir, exist_ok=True)
        self._fp = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def log_metrics(self, metrics: Dict[str, float],
                    step: Optional[int] = None):
        rec = {f"{self.prefix}{k}": float(v) for k, v in metrics.items()}
        rec["_time"] = time.time()
        if step is not None:
            rec["_step"] = step
        self._fp.write(json.dumps(rec) + "\n")
        self._fp.flush()

    def log_artifact(self, name: str, content: str):
        with open(os.path.join(self.logdir, name), "w") as fp:
            fp.write(content)

    def close(self):
        self._fp.close()
