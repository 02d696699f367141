"""Structured metrics logging (counterpart of ``avsr_tpu/utils/logging.py``).

Human-readable lines go to stderr and to an optional per-run logfile;
structured JSONL metrics (step, loss, lr, frames/sec, ...) go to
``run_dir/metrics.jsonl``, one record a line with the same keys and
values as the reference writes, and optionally mirror into TensorBoard
scalar event files under ``run_dir/tb`` (``utils/tensorboard.py``).

A record's value is stored as ``float(v)`` where that converts (Python
numbers and 0-d tensors alike), so a caller may log a device scalar: the
conversion is the one host read of it.  ``clock`` gives the records' and
the event files' wall time.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

LOGGER_NAME = "avsr_tpu_torch"


class MetricsLogger:
    """JSONL metrics + optional human-readable logfile.

    With ``tensorboard=True`` every numeric field is mirrored as a
    TensorBoard scalar (``{kind}/{field}``, noise conditions inserted as
    ``eval_noise/{condition}/{field}``).
    """

    def __init__(self, run_dir: str, logfile: Optional[str] = None,
                 tensorboard: bool = False, clock: Callable[[], float] = time.time):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._clock = clock
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        self._last_step = 0
        if tensorboard:
            from avsr_tpu_torch.utils.tensorboard import EventWriter

            self._tb = EventWriter(os.path.join(run_dir, "tb"), clock=clock)
        self._log = logging.getLogger(LOGGER_NAME)
        if not self._log.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            self._log.addHandler(h)
            self._log.setLevel(logging.INFO)
        if logfile:
            self.add_logfile(logfile)

    def log(self, kind: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"kind": kind, "time": self._clock()}
        for k, v in fields.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._write_tb(kind, rec)

    def _write_tb(self, kind: str, rec: Dict[str, Any]) -> None:
        # Event step: explicit step > non-negative epoch > last step seen
        # (eval_noise and final evals carry no step of their own).
        if "step" in rec:
            self._last_step = int(rec["step"])
        elif rec.get("epoch", -1) >= 0:
            self._last_step = int(rec["epoch"])
        prefix = kind
        if isinstance(rec.get("condition"), str):
            prefix = f"{kind}/{rec['condition']}"
        scalars = {f"{prefix}/{k}": float(v) for k, v in rec.items()
                   if k not in ("kind", "time", "step", "condition")
                   and isinstance(v, (int, float))}
        self._tb.add_scalars(scalars, self._last_step, wall_time=rec["time"])
        self._tb.flush()

    def add_logfile(self, logfile: str) -> None:
        """Attach a human-readable logfile to the logger (once per path)."""
        path = os.path.abspath(logfile)
        for h in self._log.handlers:
            if getattr(h, "baseFilename", None) == path:
                return
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        self._log.addHandler(fh)

    def info(self, msg: str) -> None:
        self._log.info(msg)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
