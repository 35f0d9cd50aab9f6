"""Export a trained model as one self-contained ``torch.export`` serving
artifact (counterpart of ``tools/export_model.py``; see
``bihome_torch/serving.py``).

    python -m bihome_torch.export_model --config_file config/...yaml \\
        [--ckpt LOGDIR_OR_FILE | --torch_ckpt F] [--set K=V ...] \\
        [--batch_size N|b] [--device cuda|cpu] [--rng_seed S] [--check] \\
        --out model.pt2

The weights come from ``--ckpt`` (a port ``model_NNNNNN.pth`` or the
newest one in a log directory), ``--torch_ckpt`` (a reference ``.pth``,
as ``bihome_torch.eval`` reads it), or else the newest port checkpoint in
LOGGING.DIR; with none, the seeded init of ``bihome_torch.eval`` (with a
warning). ``--batch_size b`` (any non-integer name) exports a
batch-polymorphic artifact (any batch from 1 to ``serving.MAX_BATCH``).
The artifact is exported for ``--device`` (``cuda`` unless ``--device
cpu``; JAX's ``--platforms``), with the model's MODEL.DTYPE. Serve it with

    from bihome_torch import serving
    predict = serving.load_exported('model.pt2')
    delta_hat = predict(patch_1, patch_2)

``--check`` loads the written file and runs a datagen batch (the test
pair spec on synthetic images; noise would make the perspective field
meaningless and the DLT ill-conditioned) through it and through the live
serving function on the same device: at most 1e-3 px apart (JAX's limit).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from bihome_torch import config as config_lib
from bihome_torch import serving
from bihome_torch.data import datasets, pipeline
from bihome_torch.device import resolve_device
from bihome_torch.eval import INIT_SEED, load_torch_checkpoint
from bihome_torch.models import backbones
from bihome_torch.training import checkpoint

CHECK_LIMIT_PX = 1e-3


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config_file', type=str, required=True)
    parser.add_argument('--ckpt', type=str, default='',
                        help='port checkpoint: a model_NNNNNN.pth or a log '
                             'directory (its newest)')
    parser.add_argument('--torch_ckpt', type=str, default='',
                        help='reference .pth (as bihome_torch.eval reads it)')
    parser.add_argument('--out', type=str, default='model.pt2')
    parser.add_argument('--batch_size', type=str, default='1',
                        help="int, or a dimension name (e.g. 'b') for a "
                             'batch-polymorphic artifact')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=('cuda', 'cpu'))
    parser.add_argument('--rng_seed', type=int, default=0)
    parser.add_argument('--check', action='store_true')
    parser.add_argument('--set', action='append', default=[],
                        metavar='KEY=VALUE')
    return parser.parse_args(argv)


def load_model(config, args) -> config_lib.BuiltModel:
    """The built model with the weights ``args`` names (see the module
    docstring)."""
    built = config_lib.build_model(config)
    model = built.model
    gen = torch.Generator().manual_seed(INIT_SEED)
    backbones.init_weights(model.backbone, gen)
    if model.score_cnn is not None:
        backbones.init_weights(model.score_cnn, gen)
    if args.torch_ckpt:
        parts = load_torch_checkpoint(model, args.torch_ckpt,
                                      config['MODEL']['BACKBONE']['NAME'])
        print(f'Loaded reference torch checkpoint ({", ".join(parts)}) '
              f'from {args.torch_ckpt}')
        return built
    path = args.ckpt or config['LOGGING']['DIR']
    if args.ckpt and not (os.path.isfile(path)
                          or checkpoint.latest_checkpoint(path)):
        raise SystemExit(f'--ckpt {args.ckpt}: no such checkpoint')
    if os.path.isfile(path) or checkpoint.latest_checkpoint(path):
        step = checkpoint.load_weights_only(path, model)
        print(f'Loaded checkpoint step {step} from {path}')
    else:
        print('WARNING: no checkpoint found; exporting the seeded init')
    return built


def check_batch(built, batch: int, device: torch.device):
    """A datagen batch of the test pair spec (synthetic 320x240 images,
    a seeded generator): (patch_1, patch_2) on ``device``."""
    ds = datasets.SyntheticDataset(image_size=(320, 240), seed=1)
    pool = torch.from_numpy(np.stack([ds.load_image(i)
                                      for i in range(batch)])).to(device)
    pairs = pipeline.generate_pairs(pool, built.test_pair_spec,
                                    torch.Generator().manual_seed(0))
    return pairs['patch_1'].float(), pairs['patch_2'].float()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = config_lib.load_config(args.config_file)
    config_lib.apply_overrides(config, args.set)
    symbolic = not args.batch_size.lstrip('-').isdigit()
    batch_size = args.batch_size if symbolic else int(args.batch_size)
    built = load_model(config, args)
    exported = serving.export_predict(built, built.model, batch_size,
                                      device, args.rng_seed)
    serving.save_exported(exported, args.out)
    shapes = serving.exported_input_shapes(args.out)
    print(f'Exported {args.out}: device={device.type}, inputs='
          f'{list(shapes)}, {os.path.getsize(args.out) / 1e6:.1f} MB')
    result = {'out': args.out, 'shapes': shapes}
    if args.check:
        n = 4 if symbolic else max(batch_size, 1)
        predict = serving.load_exported(args.out)
        live, _ = serving.make_serving_fn(built, built.model.to(device),
                                          batch_size, args.rng_seed)
        p1, p2 = check_batch(built, n, device)
        with torch.no_grad():
            got, want = predict(p1, p2), live(p1, p2)
        err = float((got - want).abs().max())
        print(f'check: max |exported - live| = {err:.3e} (delta scale '
              f'~{float(want.abs().mean()):.2f} px)')
        if not err < CHECK_LIMIT_PX:
            raise SystemExit('exported artifact diverges from the live model')
        result['check_err_px'] = err
    return result


if __name__ == '__main__':
    main()
