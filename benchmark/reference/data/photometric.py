"""Photometric distortion of the PDS-COCO configs (counterpart of
``bihome_tpu/data/photometric.py:34-97``, ``photometric_distort_simple``;
ref: src/data/transforms.py:296-330), and the full SSD chain of the
dict-stage ``PhotometricDistort`` transform (``:100-145``,
``photometric_distort_full``; ref: transforms.py:265-293).

Split in two so that the device sees one copy per batch and no branch:

* :func:`draw_photometric_params` draws every coin and uniform of a batch
  on the host from one ``torch.Generator`` into a [B, 12] float32 tensor
  (columns :data:`PARAMS`), which the caller moves to the card in one copy;
* :func:`apply_photometric` applies them to [B, H, W, 3] float images,
  batched and loop-free: brightness, the leading contrast slot, the HSV
  round trip with saturation and hue, the trailing contrast slot, the
  channel permutation.

The full chain is the same apply step on draws of fixed ranges
(:func:`draw_photometric_full_params`: brightness +-32, contrast and
saturation 0.5-1.5, hue +-18 degrees), with no identity shortcut.

As in the JAX function, exactly one contrast slot is live per sample
(``chain_coin``) and both use the one alpha draw; the hue wraps once; the
values are not clipped. ``max_delta`` 0 (S-COCO) is the identity and draws
nothing (:func:`draw_photometric_params` returns None).
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.ops import color

# Columns of the params tensor, in the order of the JAX function's draws
# (keys[0..9], then the two halves of keys[10]).
PARAMS = ('b_coin', 'b_delta', 'chain_coin', 'c1_coin', 'c_alpha', 's_coin',
          's_alpha', 'h_coin', 'h_delta', 'c2_coin', 'ln_coin', 'perm')
_COL = {name: i for i, name in enumerate(PARAMS)}
_COINS = ('b_coin', 'chain_coin', 'c1_coin', 's_coin', 'h_coin', 'c2_coin',
          'ln_coin')
# The 6 channel permutations of ImageRandomLightingNoise
# (ref: src/data/transforms.py:250-262).
_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def draw_photometric_params(batch: int, max_delta: float,
                            generator: Optional[torch.Generator] = None
                            ) -> Optional[torch.Tensor]:
    """[batch, 12] float32 CPU tensor of the distortion's draws: coins 0/1
    with p = 1/2, brightness uniform(-max_delta, max_delta), contrast and
    saturation alphas uniform(1 -/+ max_delta/64), hue uniform(-max_delta/2,
    max_delta/2), the permutation index in 0..5. None for max_delta <= 0."""
    if max_delta <= 0:
        return None
    lower = 1.0 - max_delta / 32.0 * 0.5
    upper = 1.0 + max_delta / 32.0 * 0.5
    return _draw(batch, max_delta, (lower, upper), max_delta / 2.0,
                 generator)


def draw_photometric_full_params(batch: int,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """[batch, 12] draws of the full SSD chain (``photometric.py:117-133``):
    brightness uniform(-32, 32), contrast and saturation alphas
    uniform(0.5, 1.5), hue uniform(-18, 18), coins and permutation as
    :func:`draw_photometric_params`."""
    return _draw(batch, 32.0, (0.5, 1.5), 18.0, generator)


def _draw(batch: int, brightness: float, alpha_range, hue: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    lower, upper = alpha_range
    u = torch.rand((batch, len(PARAMS)), generator=generator)
    params = torch.empty_like(u)
    for name in _COINS:
        params[:, _COL[name]] = (u[:, _COL[name]] < 0.5).float()
    for name, lo, hi in (('b_delta', -brightness, brightness),
                         ('c_alpha', lower, upper), ('s_alpha', lower, upper),
                         ('h_delta', -hue, hue)):
        params[:, _COL[name]] = lo + (hi - lo) * u[:, _COL[name]]
    params[:, _COL['perm']] = torch.floor(u[:, _COL['perm']] * 6).clamp(max=5)
    return params


def _permutation(index: torch.Tensor) -> torch.Tensor:
    """Row ``index`` [B] of :data:`_PERMS` -> [B,3] channel indices, computed
    on the index's device (no table to copy there): row k starts with
    channel k // 2 and lists the other two in order, swapped for odd k."""
    k = index.long()
    first = k // 2
    low = (first == 0).long()                 # the smaller of the other two
    high = 2 - (first == 2).long()            # the larger
    odd = (k % 2) == 1
    return torch.stack([first, torch.where(odd, high, low),
                        torch.where(odd, low, high)], dim=-1)


def apply_photometric(images: torch.Tensor,
                      params: Optional[torch.Tensor]) -> torch.Tensor:
    """images [B,H,W,3] float, params [B,12] on the same device (None: the
    identity) -> the distorted images, unclipped."""
    if params is None:
        return images
    b = images.shape[0]
    p = {name: params[:, i].reshape(b, 1, 1) for i, name in enumerate(PARAMS)}
    on = {name: p[name] > 0.5 for name in _COINS}
    one = torch.ones((), dtype=images.dtype, device=images.device)
    image = images + torch.where(on['b_coin'], p['b_delta'], 0.0)[..., None]
    c1 = on['c1_coin'] & on['chain_coin']
    image = image * torch.where(c1, p['c_alpha'], one)[..., None]
    hsv = color.rgb_to_hsv(image)
    h = hsv[..., 0] + torch.where(on['h_coin'], p['h_delta'], 0.0)
    h = torch.where(h > 360.0, h - 360.0, h)
    h = torch.where(h < 0.0, h + 360.0, h)
    s = hsv[..., 1] * torch.where(on['s_coin'], p['s_alpha'], one)
    image = color.hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1))
    c2 = on['c2_coin'] & ~on['chain_coin']
    image = image * torch.where(c2, p['c_alpha'], one)[..., None]
    permuted = torch.gather(image, -1, _permutation(params[:, _COL['perm']])[
        :, None, None, :].expand_as(image))
    return torch.where(on['ln_coin'][..., None], permuted, image)


def photometric_distort_full(images: torch.Tensor,
                             params: torch.Tensor) -> torch.Tensor:
    """The full SSD chain (``photometric_distort_full``) on [B,H,W,3] float
    images with the draws ``params`` [B,12] of
    :func:`draw_photometric_full_params`, on the images' device."""
    return apply_photometric(images, params)
