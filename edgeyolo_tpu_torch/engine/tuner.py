"""Evolutionary hyperparameter tuner (edgeyolo_tpu/engine/tuner.py).

The 23-key search space with (min, max[, gain]) bounds; each iteration
mutates the best row of `tune_results.csv` (each key with probability 0.8,
by a factor 1 + N(0, 0.2) times its gain, clipped to its bounds, rounded to
5 digits), trains a fresh model with those hyperparameters and appends its
fitness; an existing CSV resumes (its rows count toward `iterations`, its
best row seeds the mutation). The best row goes to
`best_hyperparameters.yaml`. Where JAX draws from an unseeded
`np.random.default_rng()`, the tuner takes a `np.random.Generator`, so a run
repeats from its seed.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.utils import LOGGER
from edgeyolo_tpu_torch.utils.yamlfile import yaml_save

DEFAULT_SPACE = {
    # key: (min, max[, gain])
    "lr0": (1e-5, 1e-1),
    "lrf": (0.0001, 0.1),
    "momentum": (0.7, 0.98, 0.3),
    "weight_decay": (0.0, 0.001),
    "warmup_epochs": (0.0, 5.0),
    "warmup_momentum": (0.0, 0.95),
    "box": (1.0, 20.0),
    "cls": (0.2, 4.0),
    "dfl": (0.4, 6.0),
    "hsv_h": (0.0, 0.1),
    "hsv_s": (0.0, 0.9),
    "hsv_v": (0.0, 0.9),
    "degrees": (0.0, 45.0),
    "translate": (0.0, 0.9),
    "scale": (0.0, 0.95),
    "shear": (0.0, 10.0),
    "perspective": (0.0, 0.001),
    "flipud": (0.0, 1.0),
    "fliplr": (0.0, 1.0),
    "bgr": (0.0, 1.0),
    "mosaic": (0.0, 1.0),
    "mixup": (0.0, 1.0),
    "copy_paste": (0.0, 1.0),
}


class Tuner:
    """`Tuner(args, space, save_dir, rng)(model_factory, iterations, **train_kwargs)`."""

    def __init__(self, args: dict, space: dict | None = None, save_dir: str | Path = "runs/tune",
                 rng: np.random.Generator | None = None):
        self.space = space or DEFAULT_SPACE
        self.args = dict(args)
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.csv = self.save_dir / "tune_results.csv"
        self.rng = rng if rng is not None else np.random.default_rng()

    def _mutate(self, parent: dict, mutation: float = 0.8, sigma: float = 0.2) -> dict:
        """Gaussian mutation of the best row."""
        rng = self.rng
        gains = np.array([(b[2] if len(b) > 2 else 1.0) for b in self.space.values()])
        while True:
            mask = ((rng.random(len(self.space)) < mutation)
                    * rng.standard_normal(len(self.space)) * gains * sigma)
            if np.any(mask != 0):
                break
        hyp = {}
        for (k, bounds), m in zip(self.space.items(), mask):
            base = float(parent.get(k, (bounds[0] + bounds[1]) / 2))
            hyp[k] = float(np.clip(base * (1 + m), bounds[0], bounds[1]))
        return {k: round(v, 5) for k, v in hyp.items()}

    def _rows(self) -> list[dict]:
        if not self.csv.exists():
            return []
        with open(self.csv, newline="") as f:
            return list(csv.DictReader(f))

    def _best_row(self) -> tuple[dict, float]:
        if not self.csv.exists():
            return {k: self.args.get(k, (b[0] + b[1]) / 2) for k, b in self.space.items()}, -1.0
        rows = self._rows()
        if not rows:
            return dict(self.args), -1.0
        best = max(rows, key=lambda r: float(r["fitness"]))
        return {k: float(best[k]) for k in self.space if k in best}, float(best["fitness"])

    def __call__(self, model_factory, iterations: int = 10, **train_kwargs):
        """The evolve loop: `model_factory()` gives a fresh YOLO handle each
        iteration; returns (best hyperparameters, best fitness)."""
        done = len(self._rows())
        if done:
            LOGGER.info(f"tuner: resuming from {self.csv} ({done} prior iterations)")
        for it in range(done, iterations):
            parent, best_fit = self._best_row()
            hyp = self._mutate(parent) if best_fit >= 0 else {k: float(v) for k, v in
                                                               parent.items()}
            LOGGER.info(f"tuner: iteration {it + 1}/{iterations} hyp={hyp}")
            t0 = time.time()
            try:
                fitness = model_factory().train(**{**train_kwargs, **hyp})
            except Exception as e:  # a failed fit scores 0, as in JAX; the loop goes on
                LOGGER.warning(f"tuner iteration failed: {e!r}")
                fitness = 0.0
            row = {"iter": it, "fitness": float(fitness or 0.0),
                   "time_s": round(time.time() - t0, 1), **hyp}
            write_header = not self.csv.exists()
            with open(self.csv, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(row))
                if write_header:
                    w.writeheader()
                w.writerow(row)
        best, fit = self._best_row()
        yaml_save(self.save_dir / "best_hyperparameters.yaml", best,
                  header=f"# best fitness {fit:.5f} over {iterations} iterations\n")
        LOGGER.info(f"tuner: done, best fitness {fit:.4f} -> {self.save_dir}")
        return best, fit
