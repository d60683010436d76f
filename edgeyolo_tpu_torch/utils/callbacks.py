"""The callback event bus (edgeyolo_tpu/utils/callbacks.py): named events at
which the trainers call the hooks registered for them, each with the
trainer.

`EVENTS` is JAX's table, `get_default_callbacks` an empty hook list per
event, `CallbackMixin` the registry and dispatch the trainers carry, and
`JSONLLogger` a hook that appends one JSON line per fired event (its time,
name, and the trainer's `epoch` and `best_fitness`). The trainers fire
on_train_start, on_train_epoch_start, on_train_epoch_end, on_fit_epoch_end,
on_model_save, on_train_end and teardown where JAX's do. Logger
integrations (TensorBoard and the rest) are not ported.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path

EVENTS = [
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end", "on_params_update", "teardown",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor
    "on_predict_start", "on_predict_batch_start", "on_predict_batch_end",
    "on_predict_postprocess_end", "on_predict_end",
    # exporter
    "on_export_start", "on_export_end",
]


def get_default_callbacks() -> dict:
    return defaultdict(list, {e: [] for e in EVENTS})


class CallbackMixin:
    """A callback registry and its dispatch."""

    def init_callbacks(self, callbacks: dict | None = None):
        self.callbacks = callbacks if callbacks is not None else get_default_callbacks()

    def add_callback(self, event: str, fn):
        if event not in self.callbacks:
            raise KeyError(f"unknown callback event '{event}'; valid: {EVENTS}")
        self.callbacks[event].append(fn)

    def run_callbacks(self, event: str):
        for fn in self.callbacks.get(event, []):
            fn(self)


class JSONLLogger:
    """One JSON line per fired event, appended to `path`."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def hook(self, event: str):
        def fn(obj):
            rec = {"t": round(time.time(), 3), "event": event}
            for attr in ("epoch", "best_fitness"):
                v = getattr(obj, attr, None)
                if isinstance(v, (int, float, str)):
                    rec[attr] = v
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

        return fn

    def register(self, target: CallbackMixin,
                 events=("on_train_epoch_end", "on_model_save", "on_train_end")):
        for e in events:
            target.add_callback(e, self.hook(e))
