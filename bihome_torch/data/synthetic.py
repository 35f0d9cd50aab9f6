"""Deterministic synthetic image pools for benchmarks and smoke runs.

The port's own copy of ``bihome_tpu/data/synthetic.py`` (numpy only), so
the same seed gives the same pool in both packages.

The reference trains on COCO images preprocessed offline to 320x240
(ref: src/data/coco/preprocess_offline.py). Real datasets are not present in
this environment, so benchmarks and end-to-end smoke tests draw from a
synthetic pool of smooth textured images (low-frequency noise mixtures) that
are meaningful warp targets — pure white noise would make photometric /
perceptual losses degenerate.

Channel statistics matter for the PDS protocol: natural images have
strongly correlated RGB channels (a shared luminance structure), so the
grayscale projection of a photometrically distorted copy (hue/saturation
shifts, channel permutation — ref: src/data/transforms.py:296-330) keeps
~0.99 correlation with the clean grayscale. Independent per-channel noise
fields break that property (measured: PDS-grayscale correlation drops to
~0.68 on channel-permuted draws), which makes photometric-invariant
feature learning structurally impossible on such data. The default pool
therefore uses a shared multi-scale luminance field plus small independent
chroma fields (inter-channel correlation ~0.97, matching natural-image
statistics); ``chroma=None`` restores the legacy independent-channel pool.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def make_image_pool(num_images: int, height: int = 240, width: int = 320,
                    seed: int = 0,
                    chroma: Optional[float] = 0.18) -> np.ndarray:
    """[N,H,W,3] uint8 pool of smooth multi-scale textures.

    chroma: relative amplitude of the per-channel independent fields on top
    of the shared luminance field (0.18 -> inter-channel correlation ~0.97,
    natural-image-like). ``None``: legacy fully independent channels.
    """
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)

    def field() -> np.ndarray:
        acc = np.zeros((height, width), dtype=np.float32)
        for octave in range(4):
            fx = rs.uniform(0.01, 0.05) * (2 ** octave)
            fy = rs.uniform(0.01, 0.05) * (2 ** octave)
            phase_x = rs.uniform(0, 2 * np.pi)
            phase_y = rs.uniform(0, 2 * np.pi)
            amp = rs.uniform(0.3, 1.0) / (octave + 1)
            acc += amp * np.sin(fx * xs + phase_x) * np.cos(fy * ys + phase_y)
        return acc

    pool = np.empty((num_images, height, width, 3), dtype=np.uint8)
    for n in range(num_images):
        if chroma is None:
            img = np.stack([field() for _ in range(3)], axis=-1)
        else:
            luma = field()
            img = np.stack([luma + chroma * field() for _ in range(3)],
                           axis=-1)
        img -= img.min()
        img /= max(img.max(), 1e-6)
        pool[n] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return pool
