"""The port's own copy of the JAX package's ``data/synthetic.py``.

Synthetic dataset — deterministic random images with class-dependent
structure, for tests and benchmarks (the role of the reference's
``++train.debug=True`` 3-batch smoke mode, ``trainer.py:793-795``).

Two difficulty modes:

- ``easy`` (default): class k tilts channel means by a fixed per-class
  pattern — linearly separable, a working model/trainer overfits it in a
  few steps. Used by the e2e smoke tests.
- ``hard``: each class has a fixed spatial *patch template* (one
  ``patch x patch`` pattern per channel); a sample places its class's
  template at ONE random grid-aligned location at amplitude ``alpha``,
  plus ``distractors`` templates of *other* classes at amplitude
  ``beta * alpha``, all over N(0,1) noise. The label is carried by a
  single token whose identity must be separated from near-amplitude
  impostors — Bayes accuracy sits strictly below 1 (tunable via
  alpha/beta), so quality-bearing knobs (EViT/PPT token pruning, int8,
  bf16) resolve at sub-point precision instead of an all-1.000 ceiling.
"""

from __future__ import annotations

import numpy as np

from .registry import register_dataset


@register_dataset("synthetic")
class SyntheticDataset:
    def __init__(
        self,
        *,
        split: str,
        num_samples: int = 512,
        num_classes: int = 10,
        num_channels: int = 8,
        img_size: int = 32,
        seed: int = 0,
        difficulty: str = "easy",
        patch: int = 16,
        alpha: float = 0.45,
        beta: float = 0.75,
        distractors: int = 2,
    ):
        self.split = split
        self.num_samples = int(num_samples)
        self.num_classes = int(num_classes)
        self.num_channels = int(num_channels)
        self.img_size = int(img_size)
        self.difficulty = str(difficulty)
        self.patch = int(patch)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.distractors = int(distractors)
        root = np.random.default_rng(seed + {"train": 0, "valid": 1, "test": 2}[split])
        self.labels = root.integers(0, self.num_classes, size=self.num_samples)
        # fixed class->channel-mean signature (easy mode)
        sig_rng = np.random.default_rng(1234)
        self.signatures = sig_rng.normal(0, 1, size=(self.num_classes, self.num_channels)).astype(np.float32)
        if self.difficulty == "hard":
            # fixed per-class patch templates, unit-normalised per class so
            # alpha is the per-pixel signal amplitude for every class
            t_rng = np.random.default_rng(5678)
            t = t_rng.normal(0, 1, size=(self.num_classes, self.num_channels,
                                         self.patch, self.patch)).astype(np.float32)
            t /= np.sqrt((t ** 2).mean(axis=(1, 2, 3), keepdims=True))
            self.templates = t
        self.noise_seed = seed * 1000 + {"train": 0, "valid": 1, "test": 2}[split]

    def __len__(self) -> int:
        return self.num_samples

    def get_example(self, index: int, rng=None) -> dict:
        rng = np.random.default_rng(self.noise_seed * self.num_samples + index)
        y = int(self.labels[index])
        img = rng.normal(0, 1, size=(self.num_channels, self.img_size, self.img_size)).astype(np.float32)
        if self.difficulty == "hard":
            g = self.img_size // self.patch
            n_slots = g * g
            k = 1 + self.distractors
            slots = rng.choice(n_slots, size=k, replace=False)
            others = [c for c in range(self.num_classes) if c != y]
            classes = [y] + list(rng.choice(others, size=self.distractors,
                                            replace=False))
            amps = [self.alpha] + [self.alpha * self.beta] * self.distractors
            for slot, cls, amp in zip(slots, classes, amps):
                r, c = divmod(int(slot), g)
                img[:, r * self.patch:(r + 1) * self.patch,
                    c * self.patch:(c + 1) * self.patch] += amp * self.templates[cls]
        else:
            img += self.signatures[y][:, None, None]
        return {"image": img, "label": y}
