"""What the benchmark makes from ``--seed``, on the device: the weights,
the image pool and the serving cell's patch pairs. The same seed gives the
same values, which both the program and the plain reference receive."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

# Sub-seeds of one run: each consumer of randomness draws from its own.
WEIGHTS, POOL, DRAWS, DATAGEN, DSAC, SERVING, PAIRS, ORDER, SAMPLE = range(9)


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed for consumer ``k`` of run seed ``seed`` (any int)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (k + 1)) \
        % (2 ** 63 - 1)


def _std(m: nn.Module) -> float:
    """The program's init scales: conv kernels N(0, 2 / fan_out), with
    fan_out from the weight's first axis as torch's ``kaiming_normal_``
    takes it (for a transposed conv too), dense kernels N(0, 1 / fan_in)."""
    w = m.weight
    if isinstance(m, nn.Linear):
        return m.in_features ** -0.5
    return math.sqrt(2.0 / (w.shape[0] * w.shape[2] * w.shape[3]))


@torch.no_grad()
def seeded_init(model: nn.Module, seed: int) -> None:
    """Every conv and dense kernel of ``model`` from one normal draw on its
    device (one generator, one call) at :func:`_std`, biases zero, BN the
    identity with running statistics (0, 1), and each PF head's output
    conv (the fourth layer of a module named ``PFHead``) scaled by 1/100,
    so that a random field is a few pixels. Depends only on the module
    tree's order and shapes, so two builds of one architecture get the
    same weights."""
    layers = [m for m in model.modules()
              if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    device = layers[0].weight.device
    total = sum(m.weight.numel() for m in layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    at = 0
    for m in layers:
        n = m.weight.numel()
        m.weight.copy_(flat[at:at + n].view_as(m.weight) * _std(m))
        at += n
        if m.bias is not None:
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        if type(m).__name__ == 'PFHead':
            m[3].weight.mul_(0.01)


@torch.no_grad()
def settle_batch_norm(backbone: nn.Module, batches) -> None:
    """Every BN of ``backbone`` holds, as its running statistics, the mean
    of its batch statistics over ``batches`` (batch dicts; training-mode
    forwards, no gradient), as a trained model's BN does. Without them an
    eval-mode forward of random weights normalises nothing, and its
    perspective field is far out of scale."""
    norms = [m for m in backbone.modules() if isinstance(m, nn.BatchNorm2d)]
    momentum = [m.momentum for m in norms]
    was_training = backbone.training
    backbone.train()
    for i, batch in enumerate(batches):
        for m in norms:
            m.momentum = 1.0 / (i + 1)
        backbone(batch)
    for m, mo in zip(norms, momentum):
        m.momentum = mo
    backbone.train(was_training)


@torch.no_grad()
def make_image_pool(num: int, hw: Tuple[int, int], seed: int,
                    device: torch.device, chroma: float = 0.18,
                    chunk: int = 128) -> torch.Tensor:
    """[num,H,W,3] uint8 smooth multi-scale textures on ``device``: the
    program's ``synthetic.make_image_pool`` recipe (a shared luminance
    field of four octaves of sin x cos plus three chroma fields at 0.18,
    each image stretched to 0..255), its draws from one device generator
    in one call. Each field is a sum over octaves of separable products,
    so an image costs two small outer products per octave."""
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((num, 4, 4, 5), generator=gen, device=device)
    octave = torch.arange(4, device=device, dtype=torch.float32)
    fx = (0.01 + 0.04 * u[..., 0]) * 2 ** octave            # [num,4,4]
    fy = (0.01 + 0.04 * u[..., 1]) * 2 ** octave
    px = 2 * math.pi * u[..., 2]
    py = 2 * math.pi * u[..., 3]
    amp = (0.3 + 0.7 * u[..., 4]) / (octave + 1)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    pool = torch.empty((num, h, w, 3), dtype=torch.uint8, device=device)
    mix = torch.tensor([[1.0, chroma, 0.0, 0.0], [1.0, 0.0, chroma, 0.0],
                        [1.0, 0.0, 0.0, chroma]], device=device)
    for lo in range(0, num, chunk):
        sl = slice(lo, min(num, lo + chunk))
        sx = torch.sin(fx[sl, ..., None] * xs + px[sl, ..., None])
        cy = torch.cos(fy[sl, ..., None] * ys + py[sl, ..., None])
        # fields [n,4 fields,H,W] = sum over octaves of amp * cy x sx
        fields = torch.einsum('nfo,nfoh,nfow->nfhw', amp[sl], cy, sx)
        img = torch.einsum('cf,nfhw->nhwc', mix, fields)
        lo_v = img.amin(dim=(1, 2, 3), keepdim=True)
        img = img - lo_v
        img = img / img.amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6)
        pool[sl] = (img * 255.0).clamp(0, 255).to(torch.uint8)
    return pool


def patch_pairs(pool: torch.Tensor, batches: int, batch: int,
                pair_spec, seed: int) -> Dict[str, torch.Tensor]:
    """``batches`` x ``batch`` standardized patch pairs, patch_1 and
    patch_2 [batches, batch, ps, ps, 1], synthesized from ``pool`` by the
    plain reference's pair synthesis (pool rows and draws from ``seed``)."""
    from benchmark.reference.data.pipeline import generate_pairs
    device = pool.device
    draws = torch.Generator(device=device).manual_seed(seed)
    datagen = torch.Generator().manual_seed(seed)
    p1, p2 = [], []
    with torch.no_grad():
        for _ in range(batches):
            idx = torch.randint(0, pool.shape[0], (batch,), generator=draws,
                                device=device)
            pairs = generate_pairs(pool.index_select(0, idx), pair_spec,
                                   datagen)
            p1.append(pairs['patch_1'])
            p2.append(pairs['patch_2'])
    return {'patch_1': torch.stack(p1).contiguous(),
            'patch_2': torch.stack(p2).contiguous()}
