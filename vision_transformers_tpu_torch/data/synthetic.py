"""Synthetic data backend: deterministic fake ImageNet batches.

The port's copy of ``vision_transformers_tpu/data/synthetic.py`` (numpy
only): the same seed gives the same batches bit for bit.  A batch is the
dict the train step consumes ({image NHWC f32, label1, label2, ratio}, the
MixDataset tuple of the reference, mix_dataset.py:90) as numpy arrays; the
trainer moves it to the device and to NCHW there.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

__all__ = ["SyntheticDataset"]


class SyntheticDataset:
    """Fixed-size pool of random images, cycled into batches."""

    def __init__(self, size: int, image_size: int, n_class: int = 1000, seed: int = 0,
                 normalized: bool = True):
        self.size = size
        self.image_size = image_size
        self.n_class = n_class
        rng = np.random.default_rng(seed)
        pool = min(size, 64)
        if normalized:
            self._images = rng.normal(size=(pool, image_size, image_size, 3)).astype(np.float32)
        else:
            self._images = rng.integers(0, 256, size=(pool, image_size, image_size, 3),
                                        dtype=np.uint8)
        self._labels = rng.integers(0, n_class, size=(size,)).astype(np.int32)

    def __len__(self) -> int:
        return self.size

    def batches(self, batch_size: int, seed: int = 0,
                n_batches: Optional[int] = None) -> Iterator[dict]:
        n = n_batches if n_batches is not None else max(self.size // batch_size, 1)
        idx = np.arange(batch_size)
        for i in range(n):
            sel = (idx + i * batch_size) % len(self._images)
            lab = (idx + i * batch_size) % self.size
            yield {
                "image": self._images[sel],
                "label1": self._labels[lab],
                "label2": self._labels[lab],
                "ratio": np.ones(batch_size, np.float32),
            }
