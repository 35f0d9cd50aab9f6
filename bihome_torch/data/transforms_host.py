"""Host-side transforms of the port: numpy and PIL on the host, before the
pairs are made on the device (the port's own copy of
``bihome_tpu/data/transforms_host.py``; the same calls to the seeded
``np.random.RandomState`` in the same order, so both packages crop the
same windows).

  * Rescale / RandomCrop / CenterCrop (ref: src/data/transforms.py:11-122)
  * ToGrayscale / Standardize         (ref: src/data/transforms.py:333-378)
  * PhotometricDistort  (ref: src/data/transforms.py:265-293): the full
    SSD-style chain with fixed per-op parameters (brightness delta 32,
    contrast/saturation 0.5-1.5, hue 18deg).
  * ToTensorWithTarget  (ref: src/data/transforms.py:381-396): HWC->CHW
    stacking; returns numpy.

All operate on the reference's (images, target) tuple protocol.
:func:`build_host_prep` compiles the pre-datagen subset (parsed from a
config TRANSFORMS list by ``PairSpec.from_transforms`` into
``PairSpec.host_prep``) into one per-image callable for the host datasets.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np

_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _resize_bilinear(image: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize via PIL, as the JAX package does (the reference's
    cv2 bilinear differs from PIL's at sub-LSB level)."""
    from PIL import Image
    src = image
    squeeze = src.ndim == 3 and src.shape[-1] == 1
    if squeeze:
        src = src[..., 0]
    was_float = src.dtype != np.uint8
    out = np.asarray(Image.fromarray(
        src if not was_float else src.astype(np.float32)).resize(
            (new_w, new_h), Image.BILINEAR))
    if squeeze:
        out = out[..., None]
    return out


class Rescale:
    """Aspect-aware resize (ref: src/data/transforms.py:11-46).

    int ``output_size``: the SMALLER edge is matched to it (the bigger edge
    scales by the same ratio — the reference docstring says 'bigger' but the
    code matches the smaller edge; we follow the code). tuple (w, h):
    aspect-preserving cover of the target box.
    """

    def __init__(self, output_size: Union[int, Tuple[int, int]],
                 random_state: Optional[np.random.RandomState] = None):
        assert isinstance(output_size, (int, tuple, list))
        self.output_size = (tuple(output_size)
                            if not isinstance(output_size, int)
                            else output_size)

    def __call__(self, data):
        images, targets = data
        images = list(images)
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            if isinstance(self.output_size, int):
                if h > w:
                    new_h, new_w = self.output_size * h / w, self.output_size
                else:
                    new_h, new_w = self.output_size, self.output_size * w / h
            else:
                src_ratio = h / w
                target_w, target_h = self.output_size
                if src_ratio < target_h / target_w:
                    new_w, new_h = (int(np.round(target_h / src_ratio)),
                                    target_h)
                else:
                    new_w, new_h = (target_w,
                                    int(np.round(target_w * src_ratio)))
            images[i] = _resize_bilinear(img, int(new_w), int(new_h))
        return images, targets


class CenterCrop:
    """Center crop (ref: src/data/transforms.py:87-122; note the reference
    reads the tuple as (w, h))."""

    def __init__(self, output_size: Union[int, Tuple[int, int]],
                 random_state: Optional[np.random.RandomState] = None):
        if isinstance(output_size, int):
            output_size = (output_size, output_size)
        assert len(output_size) == 2
        self.output_size = tuple(output_size)

    def __call__(self, data):
        images, targets = data
        images = list(images)
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            new_w, new_h = self.output_size
            top = (h - new_h) // 2 if h != new_h else 0
            left = (w - new_w) // 2 if w != new_w else 0
            images[i] = img[top:top + new_h, left:left + new_w]
        return images, targets


class ToGrayscale:
    """Luma grayscale of every image (ref: src/data/transforms.py:333-341)."""

    def __call__(self, data):
        images, targets = data
        images = [np.expand_dims(img[:, :, 0] * 0.299 + img[:, :, 1] * 0.587
                                 + img[:, :, 2] * 0.114, axis=-1)
                  for img in images]
        return images, targets


class Standardize:
    """(x/255 - mean)/std of every image
    (ref: src/data/transforms.py:357-366)."""

    def __init__(self, mean, std,
                 random_state: Optional[np.random.RandomState] = None):
        self.mean = mean[0] if isinstance(mean, (list, tuple)) else mean
        self.std = std[0] if isinstance(std, (list, tuple)) else std

    def __call__(self, data):
        images, targets = data
        images = [(img.astype(np.float32) / 255.0 - self.mean) / self.std
                  for img in images]
        return images, targets


class RandomCrop:
    """Random crop of every image in the sample
    (ref: src/data/transforms.py:49-84)."""

    def __init__(self, output_size: Union[int, Tuple[int, int]],
                 random_state: Optional[np.random.RandomState] = None):
        if isinstance(output_size, int):
            output_size = (output_size, output_size)
        assert len(output_size) == 2
        self.output_size = tuple(output_size)
        self.random_state = random_state or np.random

    def __call__(self, data):
        images, targets = data
        images = list(images)
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            new_h, new_w = self.output_size
            top = (self.random_state.randint(0, h - new_h)
                   if h != new_h else 0)
            left = (self.random_state.randint(0, w - new_w)
                    if w != new_w else 0)
            images[i] = img[top:top + new_h, left:left + new_w]
        return images, targets


class PhotometricDistort:
    """Full SSD photometric chain on dict keys
    (ref: src/data/transforms.py:265-293): brightness -> [contrast, ->HSV,
    saturation, hue, ->RGB (, contrast)] with a random skip of the first or
    last contrast -> random channel permutation."""

    def __init__(self, keys: Sequence[str],
                 random_state: Optional[np.random.RandomState] = None):
        self.keys = list(keys)
        self.random_state = random_state or np.random

    def _contrast(self, im):
        if self.random_state.randint(2):
            im = im * self.random_state.uniform(0.5, 1.5)
        return im

    def _saturation(self, hsv):
        if self.random_state.randint(2):
            hsv[..., 1] *= self.random_state.uniform(0.5, 1.5)
        return hsv

    def _hue(self, hsv):
        if self.random_state.randint(2):
            hsv[..., 0] += self.random_state.uniform(-18.0, 18.0)
            hsv[..., 0][hsv[..., 0] > 360.0] -= 360.0
            hsv[..., 0][hsv[..., 0] < 0.0] += 360.0
        return hsv

    def _distort_once(self, im: np.ndarray) -> np.ndarray:
        im = im.astype(np.float32).copy()
        # rand_brightness (delta 32, ref: transforms.py:145-156,283).
        if self.random_state.randint(2):
            im += self.random_state.uniform(-32.0, 32.0)
        # pd[:-1] (contrast first) or pd[1:] (contrast last),
        # ref: transforms.py:287-290.
        contrast_first = bool(self.random_state.randint(2))
        if contrast_first:
            im = self._contrast(im)
        hsv = _rgb_to_hsv(im)
        hsv = self._saturation(hsv)
        hsv = self._hue(hsv)
        im = _hsv_to_rgb(hsv)
        if not contrast_first:
            im = self._contrast(im)
        # rand_light_noise (ref: transforms.py:224-262).
        if self.random_state.randint(2):
            im = im[..., _PERMS[self.random_state.randint(len(_PERMS))]]
        return im

    def __call__(self, data):
        data = dict(data)
        for key in self.keys:
            data[key] = self._distort_once(data[key])
        return data


class ToTensorWithTarget:
    """HWC->CHW stack of (images, target)
    (ref: src/data/transforms.py:381-396). Returns numpy arrays."""

    def __call__(self, data):
        images, targets = data
        images = [np.transpose(np.asarray(img), (2, 0, 1)) for img in images]
        out_targets = (np.asarray(targets) if targets is not None else None)
        return np.asarray(images), out_targets


_HOST_PREP = {
    'Rescale': Rescale,
    'RandomCrop': RandomCrop,
    'CenterCrop': CenterCrop,
    'ToGrayscale': ToGrayscale,
    'Standardize': Standardize,
}


def build_host_prep(entries: Sequence[Tuple[str, Tuple[Any, ...]]],
                    random_state: Optional[np.random.RandomState] = None
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """Compile ``PairSpec.host_prep`` entries into one per-image callable.

    Each entry is (ClassName, ctor_args) as parsed from the config
    TRANSFORMS list (ref: train.py:110-120 instantiates the same classes by
    name). The chain runs on the (images, target) tuple protocol with a
    single image, before the on-device datagen.
    """
    chain = []
    for name, args in entries:
        cls = _HOST_PREP[name]
        try:
            chain.append(cls(*args, random_state=random_state))
        except TypeError:
            chain.append(cls(*args))

    def apply(image: np.ndarray) -> np.ndarray:
        data = ([image], None)
        for t in chain:
            data = t(data)
        return np.ascontiguousarray(data[0][0])

    return apply


def _rgb_to_hsv(im: np.ndarray) -> np.ndarray:
    r, g, b = im[..., 0], im[..., 1], im[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    d = v - mn
    sd = np.where(d == 0, 1.0, d)
    hh = np.where(v == r, 60 * (g - b) / sd,
                  np.where(v == g, 120 + 60 * (b - r) / sd,
                           240 + 60 * (r - g) / sd))
    hh = np.where(d == 0, 0.0, hh)
    hh = np.where(hh < 0, hh + 360.0, hh)
    sv = np.where(v == 0, 1.0, v)
    s = np.where(v == 0, 0.0, d / sv)
    return np.stack([hh, s, v], axis=-1)


def _hsv_to_rgb(x: np.ndarray) -> np.ndarray:
    hh, s, v = x[..., 0], x[..., 1], x[..., 2]
    h60 = hh / 60.0
    i = np.floor(h60).astype(np.int64) % 6
    f = h60 - np.floor(h60)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)
