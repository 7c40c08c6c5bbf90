"""Metrics logging: a JSONL stream always, TensorBoard events where a
writer imports.

Counterpart of ``text2img_ekl_tpu/io_utils/logging.py``. The reference
logs scalars every 100 iterations through tensorboardX
(cub_trainer_splitz_cap_ca.py:18-19, 458-460). Every scalar goes to
``<log_dir>/metrics.jsonl`` (one record a call: ``step``, ``time``, then
the scalars) and is mirrored to TensorBoard if ``tensorboardX`` or
``torch.utils.tensorboard`` imports. The writer is made at the first
record, so a run that logs nothing pays no TensorBoard import; the JSONL
file is created at once and opened for each record, so no handle outlives
it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl = os.path.join(log_dir, 'metrics.jsonl')
        open(self.jsonl, 'a').close()
        self.tb = None
        self._tb_tried = False

    def _writer(self):
        if not self._tb_tried:
            self._tb_tried = True
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(self.log_dir)
            except Exception:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self.tb = SummaryWriter(self.log_dir)
                except Exception:
                    self.tb = None
        return self.tb

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {'step': int(step), 'time': time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.jsonl, 'a') as f:
            f.write(json.dumps(rec) + '\n')
        tb = self._writer()
        if tb is not None:
            for k, v in scalars.items():
                tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        """Flush and close the TensorBoard writer; a later record opens a
        new one."""
        if self.tb is not None:
            self.tb.close()
        self.tb = None
        self._tb_tried = False
