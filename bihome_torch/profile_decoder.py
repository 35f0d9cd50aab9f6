"""The Rethinking decoder's upsampling on the card: the deconv + conv3x3
pair of each ``ResNet50DeconvBlock`` as one convolution of the composite
kernel (``ops/deconv.fused_deconv_conv3x3``, the form the port runs)
against the two-op form (ConvTranspose2d(2, 2) then Conv2d(3x3)), forward
and backward, at float32 and bfloat16.

    python -m bihome_torch.profile_decoder [--config_file X.yaml]
        [--batch_size 64]

Each block's input shape comes from one forward of the config's model at
``--batch_size`` (128x128 patches of the config, both directions of a
DoubleLine backbone stacked as the model stacks them). Times are device
ms (``utils.timing.time_ms``), one line per block and dtype, with the
largest difference of the two forms' outputs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from bihome_torch import config as config_lib
from bihome_torch.models.blocks import ResNet50DeconvBlock
from bihome_torch.ops.deconv import fused_deconv_conv3x3
from bihome_torch.utils.timing import time_ms

CONFIG = 'config/pds-coco/zeng-bihome-lr-1e-3.yaml'


def block_inputs(model, batch_size: int, patch: int, device='cuda'):
    """[(block, its input shape)] of the backbone's upsampling blocks, from
    one forward of random patches."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append((mod, tuple(args[0].shape))))
        for m in model.backbone.modules()
        if isinstance(m, ResNet50DeconvBlock)]
    data = {k: torch.rand(batch_size, patch, patch, 1, device=device)
            for k in ('patch_1', 'patch_2')}
    with torch.no_grad():
        model.backbone(data)
    for h in hooks:
        h.remove()
    return shapes


def forms(block, dtype):
    """(fused, two-op) callables x -> the upper branch's first two layers'
    output in ``dtype``."""
    deconv, conv = block.upper_branch[0], block.upper_branch[1]
    cdt = None if dtype == torch.float32 else dtype

    def fused(x):
        return fused_deconv_conv3x3(x, deconv.weight, deconv.bias,
                                    conv.weight, cdt)

    def two_op(x):
        up = F.conv_transpose2d(x, deconv.weight.to(dtype),
                                deconv.bias.to(dtype), stride=2)
        return F.conv2d(up, conv.weight.to(dtype), padding=1)
    return fused, two_op


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config_file', default=CONFIG)
    parser.add_argument('--batch_size', type=int, default=64)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('profile_decoder needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = config_lib.build_model(config_lib.load_config(args.config_file))
    model = built.model.cuda().train()
    patch = built.config['MODEL']['HEAD']['PATCH_SIZE']
    print(torch.cuda.get_device_name(0), args.config_file,
          f'batch {args.batch_size}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    for block, shape in block_inputs(model, args.batch_size, patch):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, device='cuda', generator=gen).to(dtype)
            x.requires_grad_(True)
            row = {}
            for name, fn in zip(('fused', 'two-op'), forms(block, dtype)):
                y = fn(x)
                g = torch.randn_like(y)
                row[name] = (
                    y.detach().float(),
                    time_ms(lambda: fn(x)),
                    time_ms(lambda: torch.autograd.grad(
                        fn(x), [x, block.upper_branch[0].weight,
                                block.upper_branch[1].weight], g)))
            diff = float((row['fused'][0] - row['two-op'][0]).abs().max()
                         / row['two-op'][0].abs().max())
            print(f'block input {list(shape)} {str(dtype)[6:]}: forward ms '
                  f'fused {row["fused"][1]:.4f} two-op {row["two-op"][1]:.4f};'
                  f' forward + backward ms fused {row["fused"][2]:.4f} '
                  f'two-op {row["two-op"][2]:.4f}; max |fused - two-op| / '
                  f'max |two-op| {diff:.2e}')


if __name__ == '__main__':
    main()
