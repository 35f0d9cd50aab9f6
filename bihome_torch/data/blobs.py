"""Blob occlusion (counterpart of ``bihome_tpu/data/blobs.py``; the
reference's porespy-based ``CollatorWithBlobs``, ref:
src/data/transforms.py:746-799, enabled by DATA.AUGMENT_BLOB_POROSITY /
AUGMENT_BLOBINESS): each sample's patch_2 takes, inside a binary blob
mask, the patch_1 of the sample a cyclic shift away.

The mask is porespy's ``blobs``: normal noise blurred by a separable
Gaussian (sigma = mean(H, W) / (40 blobiness), radius max(1, int(4
sigma)), the image's edge values padded), thresholded at the porosity
quantile (linear interpolation, ``jnp.percentile``'s default). The blur
is a sum of shifted copies in a fixed order, one multiply and one add a
tap, so the card and the CPU give the same bits and the same mask. The
draws,
the noise [B,H,W] and the shift in [1, B), are a parameter
(:func:`draw_blobs` makes them from a ``torch.Generator``), so a test can
pass exactly JAX's. Across ranks the draws are the global batch's and the
donors come from the global batch's patch_1
(``pipeline.generate_pairs``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from bihome_torch import tracing

Tensor = torch.Tensor


def blob_scale(shape: Tuple[int, int], blobiness: float
               ) -> Tuple[float, int]:
    """(sigma, radius) of the Gaussian for an [H,W] mask
    (``blobs.py:39-40``)."""
    h, w = shape
    sigma = float((h + w) / 2.0) / (40.0 * float(blobiness))
    return sigma, max(1, int(4 * sigma))


def gaussian_kernel(sigma: float, radius: int, dtype=torch.float32,
                    device=None) -> Tensor:
    """The normalised 1-D Gaussian over [-radius, radius]."""
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(x: Tensor, k: Tensor, radius: int, dim: int) -> Tensor:
    """'valid' convolution of the edge-padded [B,H,W] ``x`` with the
    symmetric kernel ``k`` along ``dim`` (1: columns, 2: rows)."""
    pad = (0, 0, radius, radius) if dim == 1 else (radius, radius, 0, 0)
    xp = F.pad(x[:, None], pad, mode='replicate')[:, 0]
    n = x.shape[dim]
    out = k[0] * xp.narrow(dim, 0, n)
    for j in range(1, 2 * radius + 1):
        out = out + k[j] * xp.narrow(dim, j, n)
    return out


def generate_blobs(noise: Tensor, porosity: float = 0.5,
                   blobiness: float = 1.0) -> Tensor:
    """Binary masks [B,H,W] (True on about ``porosity`` of each) from the
    normal noise [B,H,W] (``generate_blobs``, ``blobs.py:31-51``): the
    columns blurred, then the rows, each over the edge-padded image, then
    each mask thresholded below its ``porosity`` quantile."""
    b, h, w = noise.shape
    sigma, radius = blob_scale((h, w), blobiness)
    k = gaussian_kernel(sigma, radius, noise.dtype, noise.device)
    x = _blur(noise, k, radius, 1)
    x = _blur(x, k, radius, 2)
    threshold = torch.quantile(x.reshape(b, -1), porosity, dim=1)
    return x < threshold[:, None, None]


def draw_blobs(batch: int, shape: Tuple[int, int],
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Tensor, int]:
    """(normal noise [batch,H,W] float32 on the CPU, the cyclic shift in
    [1, batch))."""
    noise = torch.randn((batch,) + tuple(shape), generator=generator)
    shift = int(torch.randint(1, batch, (), generator=generator))
    return noise, shift


def apply_blob_augmentation(batch: Dict[str, Tensor], noise: Tensor,
                            shift: int, porosity: float = 0.5,
                            blobiness: float = 1.0,
                            patch_1_key: str = 'patch_1',
                            patch_2_key: str = 'patch_2',
                            donors_from: Optional[Tensor] = None,
                            lo: int = 0) -> Dict[str, Tensor]:
    """patch_2 = where(mask, roll(patch_1, shift), patch_2) per sample,
    the masks from ``noise`` (``apply_blob_augmentation``,
    ``blobs.py:54-76``: the reference picks a random other sample, JAX and
    the port a random cyclic shift, the same marginal distribution).

    Across ranks ``batch`` holds rows [lo, lo + B) of a global batch whose
    patch_1 is ``donors_from`` [total,...] (every rank's, gathered), and
    ``noise`` those rows' noise: row i takes global row (i - shift) mod
    total, as JAX's roll over its global batch gives it
    (``trainer.py:285-292``)."""
    p1, p2 = batch[patch_1_key], batch[patch_2_key]
    if noise.device.type == 'cpu':
        tracing.count_copy(p2.device, noise.nbytes)
    masks = generate_blobs(noise.to(device=p2.device, dtype=torch.float32),
                           porosity, blobiness)
    if donors_from is None:
        donors_from = p1
    total, b = donors_from.shape[0], p2.shape[0]
    rows = (torch.arange(lo, lo + b, device=p2.device) - shift) % total
    out = dict(batch)
    out[patch_2_key] = torch.where(masks[..., None],
                                   donors_from.index_select(0, rows), p2)
    return out
