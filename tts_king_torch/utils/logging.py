"""Metrics/observability sinks (the port's copy of
tts_king_tpu/utils/logging.py).

The reference logs scalars/figures/audio to wandb only (train.py:116-120,
fs_two/utils/tools.py:86-118). Here the primary sink is structured JSONL on
disk (works offline, greppable) with an optional wandb mirror when the
package + key are available, plus per-step timing — the tracing the reference
lacks (SURVEY.md §5.1, §5.5).
"""

import json
import os
import time
from typing import Any, Dict, Optional

LOSS_NAMES = ("total", "mel", "pitch", "energy", "duration",
              "pitch_mean", "pitch_std")


class MetricsLogger:
    def __init__(self, log_dir: str, exp_name: str = "run",
                 wandb_key: Optional[str] = None, offline: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{exp_name}.metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._wandb = None
        if wandb_key or os.environ.get("WANDB_API_KEY"):
            try:
                import wandb

                if offline:
                    os.environ["WANDB_MODE"] = "offline"
                if wandb_key:
                    os.environ.setdefault("WANDB_API_KEY", wandb_key)
                wandb.init(project=exp_name, reinit=True)
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, step: int, scalars: Dict[str, Any], prefix: str = "train"):
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3),
               "phase": prefix}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log({f"{prefix}/{k}": v for k, v in scalars.items()},
                            step=int(step))

    def log_losses(self, step: int, losses, prefix: str = "train",
                   extra: Optional[Dict[str, Any]] = None):
        scalars = {name: float(val)
                   for name, val in zip(LOSS_NAMES, tuple(losses))}
        if extra:
            scalars.update(extra)
        self.log(step, scalars, prefix)

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
