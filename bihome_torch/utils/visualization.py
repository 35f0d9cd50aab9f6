"""Eval visualization: rectangle overlays and warp GIFs, numpy and PIL only
(the port's own copy of ``bihome_tpu/utils/visualization.py``; ref:
eval.py:44-57 draws with cv2.line, eval.py:247-272 writes GIFs with
imageio).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_COLORS = {'r': (255, 0, 0), 'g': (0, 255, 0), 'b': (0, 0, 255)}


def _draw_line(image: np.ndarray, p0, p1, rgb, thickness: int = 2) -> None:
    h, w = image.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = (x0 + (x1 - x0) * ts).round().astype(int)
    ys = (y0 + (y1 - y0) * ts).round().astype(int)
    r = thickness // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            xi = np.clip(xs + dx, 0, w - 1)
            yi = np.clip(ys + dy, 0, h - 1)
            image[yi, xi] = rgb


def draw_rect(image: np.ndarray, corners: np.ndarray, color: str = 'b',
              thickness: int = 2) -> np.ndarray:
    """The quadrilateral through 4 corners [4,2] (x, y) drawn on a copy of
    the [H,W,3] uint8 image (ref: eval.py:44-57)."""
    out = np.ascontiguousarray(image).copy()
    rgb = _COLORS[color]
    for i in range(4):
        _draw_line(out, corners[i], corners[(i + 1) % 4], rgb, thickness)
    return out


def save_gif(path: str, frames: Sequence[np.ndarray],
             duration: float = 0.5) -> None:
    """Animated GIF of [H,W,{1,3}] uint8 frames (ref: eval.py:268-272)."""
    from PIL import Image
    imgs = []
    for f in frames:
        arr = np.asarray(f)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = np.tile(arr, (1, 1, 3))
        imgs.append(Image.fromarray(arr.astype(np.uint8)))
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(duration * 1000), loop=0)
