"""CIFAR-10 dataset (robustness experiments); the port's own copy of
``bihome_tpu/data/cifar10.py``.

Equivalent of the reference's vendored torchvision CIFAR10
(ref: src/data/cifar10/dataset.py:114-291): reads the standard
``cifar-10-batches-py`` pickle files directly with numpy, exposes the
train/test splits, and plugs into the same synthesis pipeline (32x32
images are used with patch_size == width, which the datagen handles by
centering the patch, ref: transforms.py:507-509).
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

_TRAIN_BATCHES = [f'data_batch_{i}' for i in range(1, 6)]
_TEST_BATCHES = ['test_batch']


class Cifar10Dataset:
    def __init__(self, dataset_root: str, train: bool = True):
        base = dataset_root
        sub = os.path.join(dataset_root, 'cifar-10-batches-py')
        if os.path.isdir(sub):
            base = sub
        names = _TRAIN_BATCHES if train else _TEST_BATCHES
        arrays = []
        for name in names:
            path = os.path.join(base, name)
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            with open(path, 'rb') as f:
                entry = pickle.load(f, encoding='latin1')
            arrays.append(np.asarray(entry['data'], dtype=np.uint8))
        data = np.concatenate(arrays)                     # [N, 3072]
        self.images = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

    def __len__(self) -> int:
        return len(self.images)

    def load_image(self, idx: int) -> np.ndarray:
        return self.images[idx]
