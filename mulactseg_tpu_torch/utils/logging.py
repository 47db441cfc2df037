"""Run logging, the port's copy of mulactseg_tpu/utils/logging.py: file
logger, the always-on metrics.jsonl stream (the same lines as the JAX
package's) and an optional wandb mirror."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

from mulactseg_tpu_torch.parallel import mesh


def get_file_logger(save_dir: str, name: str = "mulactseg_tpu_torch",
                    fname: str = "log_train.txt") -> logging.Logger:
    """The run's logger: INFO to save_dir/fname and the console. Under
    data parallelism only rank 0 logs; the others keep warnings, on the
    console."""
    logger = logging.getLogger(name)
    if not mesh.is_main():
        logger.setLevel(logging.WARNING)
        return logger
    os.makedirs(save_dir, exist_ok=True)
    logger.setLevel(logging.INFO)
    path = os.path.join(save_dir, fname)
    if not any(getattr(h, "baseFilename", None) == os.path.abspath(path)
               for h in logger.handlers):
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(fh)
    if not any(isinstance(h, logging.StreamHandler) and
               not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        logger.addHandler(logging.StreamHandler())
    return logger


class MetricsSink:
    """Always-on JSONL metric stream + optional wandb mirror; under data
    parallelism rank 0's alone (the others' log() writes nothing)."""

    def __init__(self, save_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        self.path = None
        self.wandb = None
        if not mesh.is_main():
            return
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        if use_wandb:
            try:
                import wandb  # noqa: F401 - optional

                self.wandb = wandb.init(**(wandb_kwargs or {}))
            except Exception:
                self.wandb = None

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        if self.path is None:
            return
        rec = dict(metrics)
        if step is not None:
            rec["step"] = int(step)
        rec["time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)
