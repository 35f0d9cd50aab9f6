"""Eval entry point of the port — MACE over the test protocol
(counterpart of ``eval.py:104-306``).

    python -m bihome_torch.eval --config_file X.yaml [--batch_size N]
        [--steps N] [--synthetic] [--image_size W H] [--set K=V]
        [--ckpt DIR_OR_FILE | --torch_ckpt F] [--log F] [--skip_timing]
        [--device cuda|cpu]

Prints ``Number of params``, ``Mean mace`` and ``Mean model time`` (ms per
batch) like the JAX entry point. The images come from DATA.TEST_SPLIT
(``datasets.make_dataset``: an image or ``.npy`` folder, a ``.bhpk``
pack, a CIFAR-10 pickle directory, the synthetic images when the path
does not exist) with the config's host-side prep, or with ``--synthetic``
from the synthetic images. Protocol: TEST_SAMPLES_PER_EPOCH samples
drawn with replacement by the seeded epoch sampler, each sample's pair
synthesized from its own generator seeded by (TEST_SEED, ordinal) — so MACE
does not depend on ``--batch_size`` — and DSAC or RANSAC draws seeded by
(TEST_SEED + 1, iteration); RANSAC (zeng-orig's NoOp 'all_points' head)
draws on the device, from a generator there. Timing covers predict only
(the RANSAC fit included), over batches generated beforehand, each call
ended by ``torch.cuda.synchronize()``; the first iteration is dropped.
CLEVR-Change pairs carry no ground-truth homography and are refused.

Weights: ``--ckpt`` loads a port checkpoint (a ``model_NNNNNN.pth`` or
the newest one in a log directory, ``training/checkpoint.py``);
``--torch_ckpt`` a reference ``.pth``; with neither, the newest port
checkpoint in LOGGING.DIR (``eval.py:154-159``), else a fixed seed's init.
``--log F`` appends one ``iter,mace`` line per sample (``eval.py:
243-247``). Runs on ``cuda`` unless ``--device cpu`` is given; without a
card it raises rather than falling back.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bihome_torch import config as config_lib
from bihome_torch.data import datasets, pipeline
from bihome_torch.device import resolve_device
from bihome_torch.models import backbones, weights
from bihome_torch.training import checkpoint

INIT_SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config_file', type=str, required=True)
    parser.add_argument('--ckpt', type=str, default='',
                        help='port checkpoint: a model_NNNNNN.pth or a log '
                             'directory (its newest)')
    parser.add_argument('--torch_ckpt', type=str, default='',
                        help='reference .pth: a backbone state dict or a '
                             'training checkpoint {"model": {"0.*": ...}}')
    parser.add_argument('--log', type=str, default='',
                        help='append one "iter,mace" line per sample')
    parser.add_argument('--batch_size', type=int, default=1)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--skip_timing', action='store_true')
    parser.add_argument('--steps', type=int, default=0)
    parser.add_argument('--image_size', type=int, nargs=2,
                        default=(320, 240))
    parser.add_argument('--set', action='append', default=[],
                        metavar='KEY=VALUE', help='dotted config override')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=('cuda', 'cpu'))
    return parser.parse_args(argv)


def load_backbone_weights(backbone: torch.nn.Module, path: str) -> None:
    """Load a reference .pth into the backbone: either its own state dict
    or a training checkpoint of nn.Sequential(backbone, head), whose
    backbone keys carry the '0.' prefix (ref: train.py:696)."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(state, dict) and 'model' in state:
        state = state['model']
    if any(k.startswith('0.') for k in state):
        state = {k[2:]: v for k, v in state.items() if k.startswith('0.')}
    weights.load_state_dict(backbone, state)


def dsac_generator(test_seed: int, iteration: int,
                   device='cpu') -> torch.Generator:
    """Generator of the DSAC (CPU) or RANSAC (``device``) draws for eval
    iteration ``iteration``."""
    return torch.Generator(device=device).manual_seed(
        pipeline.sample_seed(test_seed + 1, iteration))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the eval; returns the printed numbers plus the built model and
    the generated batches (for callers that check them further)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        # Full fp32, as the JAX reference computes on CPU; TF32 would keep
        # ~3 decimal digits in every conv.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = config_lib.load_config(args.config_file)
    config_lib.apply_overrides(config, args.set)
    sampler_cfg = config['DATA']['SAMPLER']
    test_seed = int(sampler_cfg.get('TEST_SEED', 42))
    batch_size = args.batch_size
    test_samples = sampler_cfg['TEST_SAMPLES_PER_EPOCH']
    if args.steps:
        test_samples = min(test_samples, args.steps * batch_size)
    num_iters = test_samples // batch_size
    if num_iters < 1:
        raise ValueError(f'--batch_size {batch_size} exceeds the '
                         f'{test_samples} test samples')
    n_eval = num_iters * batch_size

    built = config_lib.build_model(config)
    if built.test_pair_spec.change_aware_keys:
        raise ValueError('CLEVR-Change pairs have no ground-truth homography:'
                         ' there is no MACE to evaluate')
    model = built.model
    if args.torch_ckpt:
        load_backbone_weights(model.backbone, args.torch_ckpt)
    else:
        backbones.init_weights(model.backbone,
                               torch.Generator().manual_seed(INIT_SEED))
        log_dir = config['LOGGING']['DIR']
        if args.ckpt or checkpoint.latest_checkpoint(log_dir):
            path = args.ckpt or log_dir
            step = checkpoint.load_weights_only(path, model)
            print(f'Loaded checkpoint step {step} from {path}')
    model = model.to(device).eval()

    image_size = tuple(args.image_size)
    data_cfg = config['DATA']
    ds = (datasets.SyntheticDataset(image_size=image_size, seed=1)
          if args.synthetic else
          datasets.make_dataset(data_cfg.get('TEST_SPLIT', ''),
                                image_size=image_size, synthetic_seed=1,
                                dataset_name=data_cfg.get('NAME', 'coco')))
    if built.test_pair_spec.host_prep:
        ds = datasets.HostPrepDataset(ds, built.test_pair_spec.host_prep,
                                      random_seed=sampler_cfg.get('TEST_SEED'))
        ds.load_image(0)        # JAX's init sample draws once
    print(f'Test split: {datasets.describe(ds)} ({len(ds)})'
          + ('' if args.synthetic else
             f' from {data_cfg.get("TEST_SPLIT", "")}'))
    indices = datasets.EpochSampler(len(ds), n_eval,
                                    random_seed=test_seed).epoch_indices()
    uniq, inv = np.unique(indices, return_inverse=True)
    pool = torch.from_numpy(
        np.stack([ds.load_image(int(i)) for i in uniq])).to(device)
    sample_to_pool = torch.from_numpy(inv.reshape(num_iters, batch_size))

    spec = built.test_pair_spec
    batches: List[Dict[str, torch.Tensor]] = []
    for it in range(num_iters):
        seeds = [pipeline.sample_seed(test_seed, it * batch_size + i)
                 for i in range(batch_size)]
        images = pipeline.take_images(pool, sample_to_pool[it].to(device))
        batches.append(pipeline.generate_pairs_per_sample(images, seeds, spec))

    maces, times = [], []
    gen_device = device if model.draws_on_device else torch.device('cpu')
    for it, batch in enumerate(batches):
        start = time.perf_counter()
        delta_hat = model.predict(
            batch, generator=dsac_generator(test_seed, it, gen_device))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - start)
        diff = batch['delta'] - delta_hat
        maces.append(torch.linalg.vector_norm(diff, dim=-1).mean(-1).cpu())
    maces_np = torch.cat(maces).numpy()
    timed = times[1:] if len(times) > 1 else times
    per_batch_ms = float(np.mean(timed)) * 1000.0

    if args.log:
        with open(args.log, 'a') as f:
            for it, m in enumerate(maces_np):
                f.write(f'{it},{float(m)}\n')
    # The predict model: the backbone (the frozen loss extractor is not
    # part of predict).
    num_params = sum(p.numel() for p in model.backbone.parameters())
    print(f'Number of params: {num_params}')
    print(f'Mean mace: {float(np.mean(maces_np))}')
    if not args.skip_timing:
        print(f'Mean model time: {per_batch_ms}')
    return {'num_params': num_params, 'mean_mace': float(np.mean(maces_np)),
            'maces': maces_np, 'per_batch_ms': per_batch_ms,
            'batch_size': batch_size, 'num_iters': num_iters,
            'test_seed': test_seed, 'model': model, 'batches': batches,
            'built': built}


if __name__ == '__main__':
    main()
