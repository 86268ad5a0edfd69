"""Training-scalar sink: OUTPUT_DIR/metrics.jsonl (or ``name``) always, one
JSON object per log step, TensorBoard events as well when
``torch.utils.tensorboard`` can be imported (it needs the ``tensorboard``
package)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, out_dir: str, tb_dir: Optional[str] = None, name: str = "metrics.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(os.path.join(out_dir, name), "a")
        self._tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass  # no tensorboard package: JSONL only
            else:
                self._tb = SummaryWriter(tb_dir)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **scalars}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
