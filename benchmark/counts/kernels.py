"""The least time each of the port's kernels could take on the card, from
the shapes of one call: the operations the algorithm needs over the peak
rate and the bytes it must move over the memory's, the larger of the two.

Rules, so that a share of this bound is a lower bound and never passes
100%: each input is read once and each output written once; weights and
statistics (kilobytes) are left out; a warp's source image is left out
(its taps touch an unknown part of it); the PF head's products are the
algorithm's (one product each, not 3xTF32's three) at the TF32 rate, and
its backward counts no recomputation of the forward's middle.

Kinds, as ``benchmark/harness/trace.log_port_calls`` logs them:

* ``k1``, the PF head forward: x [N,Cin,H,W] -> [N,Cout,H,W] through
  Cmid; 2 P (Cin Cmid + Cmid Cout) operations over P = N H W pixels;
* ``k2``, its backward: x and the output's cotangent in, dx out;
  2 P (2 Cin Cmid + 2 Cmid Cout) operations (d middle, dx, dw1, dw2);
* ``k3``, a bilinear sample: the points' u, v in (one row when they are
  broadcast over the batch), [N,P,C] out;
* ``k4``, its point gradient: u, v and the cotangent in, du, dv out;
* ``k5``, its image gradient: u, v and the cotangent in, the image's
  gradient [N,H,W,C] out.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

PEAKS = json.loads((Path(__file__).with_name('peaks.json')).read_text())
F32 = 4


def flops_bytes(kind: str, s: Dict) -> Tuple[float, float]:
    """(operations, bytes) of one call of ``kind`` with shapes ``s``."""
    if kind in ('k1', 'k2'):
        n, cin, h, w = s['x']
        cmid, cout = s['w1'][0], s['w2'][0]
        pixels = n * h * w
        act = s['bytes_per']
        if kind == 'k1':
            return (2.0 * pixels * (cin * cmid + cmid * cout),
                    float(pixels * (cin + cout) * act))
        return (2.0 * pixels * (2 * cin * cmid + 2 * cmid * cout),
                float(pixels * (2 * cin + cout) * act))
    n, h, w, c = s['images']
    p = s['points']
    uv = 2.0 * F32 * p * s['uv_rows']
    if kind == 'k3':
        return 0.0, uv + F32 * n * p * c
    if kind == 'k4':
        return 0.0, uv + F32 * n * p * c + 2.0 * F32 * n * p
    if kind == 'k5':
        return 0.0, uv + F32 * n * p * c + F32 * n * h * w * c
    raise ValueError(kind)


def bound_s(kind: str, shapes: Dict) -> float:
    """The call's least time in seconds on the card."""
    ops, nbytes = flops_bytes(kind, shapes)
    return max(ops / PEAKS['tf32_flops_per_s'],
               nbytes / PEAKS['hbm_bytes_per_s'])
