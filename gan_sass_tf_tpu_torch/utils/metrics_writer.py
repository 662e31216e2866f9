"""JSONL metrics sink: one JSON object a line, {"step", "time", metrics...},
with an optional TensorBoard mirror.

Port of `gan_sass_tf_tpu/utils/metrics_writer.py`.  JSONL stays the source
of truth; with `tensorboard_dir` every float metric of a write is also a
scalar of one event at that step, in an event file written by
`utils/tb_events.py` (the JAX writer goes through tf.summary and drops the
mirror when TensorFlow is missing; this one needs nothing to write it)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from gan_sass_tf_tpu_torch.utils.tb_events import EventWriter


class MetricsWriter:
    def __init__(self, path: Optional[str], tensorboard_dir: Optional[str] = None):
        self._fh = None
        self._tb = EventWriter(tensorboard_dir) if tensorboard_dir else None
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
        if self._tb is not None:
            self._tb.scalars(int(step), {
                k: v for k, v in record.items()
                if k not in ("step", "time") and isinstance(v, float)})

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
