"""JSONL metrics sink: one JSON object a line, {"step", "time", metrics...}.

A copy of `gan_sass_tf_tpu/utils/metrics_writer.py` without its optional
TensorBoard mirror (that package's `utils/__init__.py` imports JAX, and the
mirror needs TensorFlow)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsWriter:
    def __init__(self, path: Optional[str]):
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
