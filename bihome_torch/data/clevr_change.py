"""CLEVR-Change pairs for the port: the file-backed dataset, the pair
sampler, the pair loader and the synthetic stand-in (counterparts of
``bihome_tpu/data/clevr_change.py:19-151``; ref:
src/data/clevr_change/dataset.py:12-152).

An index addresses the concatenated space [originals | nsc renders | sc
renders]; the sampler pairs each original with a changed render of the
same scene (patch_2_idx = idx + k·N).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from bihome_torch.data.datasets import (SyntheticDataset, _decode_image,
                                        fit_image)

MODES = ('nsc', 'sc', 'both')


def _list_images(dirpath: str) -> List[str]:
    names = sorted(f for f in os.listdir(dirpath)
                   if f.lower().endswith(('.jpg', '.png', '.jpeg')))
    return [os.path.join(dirpath, f) for f in names]


class ClevrChangeDataset:
    """A CLEVR-Change root: ``images/`` (the originals), ``nsc_images/``
    and ``sc_images/`` (the non-semantic and semantic change renders, in
    the same sorted order) (``clevr_change.py:19-55``)."""

    def __init__(self, dataset_root: str,
                 image_size: Tuple[int, int] = (320, 240)):
        self.image_size = image_size
        self.filepaths = _list_images(os.path.join(dataset_root, 'images'))
        self.nsc_filepaths = _list_images(
            os.path.join(dataset_root, 'nsc_images'))
        self.sc_filepaths = _list_images(
            os.path.join(dataset_root, 'sc_images'))
        if not self.filepaths:
            raise FileNotFoundError(dataset_root)

    def __len__(self) -> int:
        return len(self.filepaths)

    def load_image(self, idx: int) -> np.ndarray:
        """[0, N) originals, [N, 2N) nsc renders, [2N, 3N) sc renders
        (ref: clevr_change/dataset.py:74-81)."""
        n = len(self)
        if idx < n:
            path = self.filepaths[idx]
        elif idx < 2 * n:
            path = self.nsc_filepaths[idx - n]
        else:
            path = self.sc_filepaths[idx - 2 * n]
        return fit_image(_decode_image(path), self.image_size)


class ClevrChangePairSampler:
    """Per-epoch (original, changed) index pairs (``clevr_change.py:58``).
    mode: 'nsc' (non-semantic change), 'sc' (semantic change) or 'both'."""

    def __init__(self, dataset, batch_size: int,
                 samples_per_epoch: int = 10000, mode: str = 'nsc',
                 random_seed: Optional[int] = None):
        if mode not in MODES:
            raise ValueError(f'CLEVR-Change MODE {mode!r}: one of {MODES}')
        self.dataset = dataset
        self.batch_size = batch_size
        self.samples_per_epoch = samples_per_epoch
        self.mode = mode
        self.random_state = (np.random.RandomState(random_seed)
                             if random_seed is not None else np.random)

    def __len__(self) -> int:
        return self.samples_per_epoch // self.batch_size

    def epoch_pairs(self) -> np.ndarray:
        """[samples_per_epoch, 2] of (patch_1_idx, patch_2_idx)."""
        n = len(self.dataset)
        idx1 = self.random_state.choice(n, self.samples_per_epoch)
        if self.mode == 'both':
            offsets = self.random_state.choice([1, 2],
                                               self.samples_per_epoch)
        elif self.mode == 'nsc':
            offsets = np.ones(self.samples_per_epoch, np.int64)
        else:
            offsets = np.full(self.samples_per_epoch, 2, np.int64)
        return np.stack([idx1, idx1 + offsets * n], axis=1)


class ClevrPairLoader:
    """[B,2,H,W,3] uint8 (original, changed) pair batches in the sampler's
    order (``clevr_change.py:91``): streamed per epoch, or a pool of pairs
    for the device."""

    def __init__(self, dataset, batch_size: int, samples_per_epoch: int,
                 mode: str = 'nsc', random_seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = ClevrChangePairSampler(
            dataset, batch_size, samples_per_epoch, mode=mode,
            random_seed=random_seed)

    def __len__(self) -> int:
        return len(self.sampler)

    def load_pair(self, i1: int, i2: int) -> np.ndarray:
        return np.stack([self.dataset.load_image(int(i1)),
                         self.dataset.load_image(int(i2))])

    def epoch(self):
        pairs = self.sampler.epoch_pairs()
        b = self.batch_size
        for k in range(len(pairs) // b):
            chunk = pairs[k * b:(k + 1) * b]
            yield np.stack([self.load_pair(i1, i2) for i1, i2 in chunk])

    def pool(self, n: int) -> np.ndarray:
        """[n,2,H,W,3]: the first ``n`` pairs of the next epoch (the epoch
        repeated if it is shorter)."""
        pairs = self.sampler.epoch_pairs()
        reps = -(-n // len(pairs))
        pairs = np.tile(pairs, (reps, 1))[:n]
        return np.stack([self.load_pair(i1, i2) for i1, i2 in pairs])


class SyntheticChangeDataset:
    """Synthetic stand-in with the CLEVR index space (``clevr_change.py:
    127-151``): section k of index i is base image i % N under a small
    per-index colour shift (none for the originals), so an 'nsc' pair is
    the same scene under a small change. The same seed gives the same
    images as the JAX package's."""

    def __init__(self, num_images: int = 64,
                 image_size: Tuple[int, int] = (320, 240), seed: int = 0):
        self.num_images = num_images
        self._base = SyntheticDataset(num_images=num_images,
                                      image_size=image_size, seed=seed)
        self._rng_seed = seed

    def __len__(self) -> int:
        return self.num_images

    def load_image(self, idx: int) -> np.ndarray:
        section, base_idx = divmod(int(idx), self.num_images)
        img = self._base.load_image(base_idx)
        if section == 0:
            return img
        rng = np.random.RandomState(self._rng_seed * 7919 + idx)
        out = img.astype(np.int16) + rng.randint(-12, 13, size=(1, 1, 3))
        return np.clip(out, 0, 255).astype(np.uint8)
