"""Host-side datasets for the port: the synthetic pool and the seeded epoch
sampler (counterparts of ``bihome_tpu/data/datasets.py:119-150``).

Real-dataset listing and decoding are not ported yet; the eval entry point
runs on ``--synthetic`` images.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from bihome_torch.data import synthetic


class SyntheticDataset:
    """Deterministic stand-in when no dataset directory exists."""

    def __init__(self, num_images: int = 256,
                 image_size: Tuple[int, int] = (320, 240), seed: int = 0):
        w, h = image_size
        self.pool = synthetic.make_image_pool(num_images, h, w, seed=seed)

    def __len__(self) -> int:
        return len(self.pool)

    def load_image(self, idx: int) -> np.ndarray:
        return self.pool[idx]


class EpochSampler:
    """Seeded per-epoch index choice with replacement
    (ref: src/data/coco/dataset.py:136-142)."""

    def __init__(self, dataset_len: int, samples_per_epoch: int,
                 random_seed: Optional[int] = None):
        self.dataset_len = dataset_len
        self.samples_per_epoch = samples_per_epoch
        self.random_state = (np.random.RandomState(random_seed)
                             if random_seed is not None else np.random)

    def epoch_indices(self) -> np.ndarray:
        return self.random_state.choice(np.arange(self.dataset_len),
                                        self.samples_per_epoch)
