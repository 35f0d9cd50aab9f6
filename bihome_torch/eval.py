"""Eval entry point of the port — MACE over the test protocol
(counterpart of ``eval.py:104-306``).

    python -m bihome_torch.eval --config_file X.yaml [--batch_size N]
        [--steps N] [--synthetic] [--image_size W H] [--set K=V]
        [--ckpt DIR_OR_FILE | --torch_ckpt F] [--log F] [--skip_timing]
        [--vis] [--vis_dir DIR] [--device cuda|cpu]
        [--multihost [--coordinator HOST:PORT --num_processes N
                      --process_id R]]

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
``--torch_ckpt`` a reference ``.pth``, the backbone and the head's parts
it holds (the extractor, the projection head, the DSAC score CNN;
``torchvision_port.load_reference_checkpoint``, as ``eval.py:140-150``);
with neither, the newest port checkpoint in LOGGING.DIR (``eval.py:
154-159``), else a fixed seed's init. ``--log F`` appends one
``iter,mace`` line per sample (``eval.py:243-247``). ``--vis`` makes the
test pairs emit ``image_2`` (the whole frame warped by the pair's
homography, K3 on the card) and writes, per sample n, into ``--vis_dir``
the files of ``eval.py:46-100``: ``{n:05d}_image_vis.png`` (image_2 with
the true corners in blue and the predicted ones in red),
``{n:05d}_patch_1_2_mask.gif`` (patch_1 warped by delta_hat, patch_2,
the warped mask) and ``{n:05d}_{warped,patch_2,mask_1,mask_2}.npy``
(plus ``{n:05d}_pf.npy`` where the model predicts a perspective field). The model computes in MODEL.DTYPE (``--set
MODEL.DTYPE=bfloat16``, as JAX's eval reads it); its float32 weights load
at either dtype. Runs on ``cuda`` unless ``--device cpu`` is given;
without a card it raises rather than falling back.

``--multihost`` (``eval.py:224-231, 331-338``; the process group as
``bihome_torch.train`` starts it) splits the iterations over the ranks
in contiguous runs; each rank generates and predicts only its own (the
draws are seeded per sample and per iteration, so they are the
one-process run's), the per-sample MACEs are gathered to rank 0 in
sample order, and rank 0 alone prints and writes ``--log``: the same
mean and log as one process. (JAX's processes each evaluate every
iteration, so its gathered log repeats every sample R times; the port
lists each once. Its ``--vis`` files are each rank's own samples.) The
model time printed is rank 0's.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

import dataclasses
import os

from bihome_torch import config as config_lib
from bihome_torch import geometry
from bihome_torch.data import datasets, pipeline
from bihome_torch.models import backbones, torchvision_port
from bihome_torch.ops import color
from bihome_torch.parallel import dist_util, mesh
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
    parser.add_argument('--vis', action='store_true',
                        help='write the per-sample visualization files')
    parser.add_argument('--vis_dir', type=str, default='vis_out')
    parser.add_argument('--steps', type=int, default=0)
    parser.add_argument('--image_size', type=int, nargs=2,
                        default=(320, 240))
    parser.add_argument('--set', action='append', default=[],
                        metavar='KEY=VALUE', help='dotted config override')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=('cuda', 'cpu'))
    mesh.add_arguments(parser)
    return parser.parse_args(argv)


def load_torch_checkpoint(model: torch.nn.Module, path: str,
                          backbone_name: str) -> List[str]:
    """Load a reference .pth into the model: the backbone's own state dict,
    or a training checkpoint of nn.Sequential(backbone, head) (keys '0.*'
    and '1.*', ref: train.py:696), whose head parts load too. Returns the
    parts loaded."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(state, dict) and 'model' in state:
        state = state['model']
    return torchvision_port.load_reference_checkpoint(model, state,
                                                      backbone_name)


def vis_outputs(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                delta_hat: torch.Tensor) -> Dict[str, np.ndarray]:
    """The arrays the visualization files show for one batch
    (``eval.py:248-304``): patch_1 warped by the homography of delta_hat
    over the patch, the warp of an all-ones mask (closed form), ones as
    mask_2, patch_2, the corners, the deltas, image_2 where the batch has
    it; with MASK_KEYS the backbone's mask_1 warped and its mask_2, and
    the perspective field where the head reads one. On the CPU, numpy."""
    head = model.head
    patch_1 = batch['patch_1']
    b, ps = patch_1.shape[0], patch_1.shape[1]
    corners = geometry.image_corners(ps, ps, batch_size=b,
                                     device=patch_1.device)
    hom = geometry.four_point_to_homography(corners, delta_hat.float())
    u, v = geometry.homography_grid(hom, (ps, ps))
    out = {'warped': geometry.batched_sample(patch_1, u, v).reshape(
               patch_1.shape),
           'mask_1_warped': geometry.ones_warp_mask(u, v, (ps, ps)).reshape(
               b, ps, ps, 1),
           'mask_2': torch.ones_like(patch_1), 'patch_2': batch['patch_2'],
           'corners': batch['corners'], 'delta': batch['delta'],
           'delta_hat': delta_hat}
    if 'image_2' in batch:
        out['image_2'] = batch['image_2']
    pf_key = head.pf_keys[0] if head.pf_keys else None
    if head.mask_keys or pf_key:
        with torch.no_grad():
            bb = model.backbone(batch)
        if head.mask_keys:
            m1 = bb[head.mask_keys[0]]
            out['mask_1_warped'] = geometry.batched_sample(
                m1, u, v).reshape(m1.shape)
            out['mask_2'] = bb[head.mask_keys[1]]
        if pf_key is not None:
            out['pf'] = bb[pf_key]
    return {k: v.detach().float().cpu().numpy() for k, v in out.items()}


def save_visualization(out_dir: str, it: int, batch_size: int,
                       vis_batch: Dict[str, np.ndarray]) -> None:
    """One set of files per sample n = it * batch_size + idx
    (``eval.py:46-100``, ref: eval.py:145-332)."""
    from PIL import Image
    from bihome_torch.utils import visualization as vis
    os.makedirs(out_dir, exist_ok=True)

    def to_u8(img):
        arr = color.destandardize(torch.from_numpy(img)).numpy()
        return np.tile(arr.astype(np.uint8), (1, 1, 3))

    for idx in range(batch_size):
        n = it * batch_size + idx
        warped = vis_batch['warped'][idx]
        patch_2 = vis_batch['patch_2'][idx]
        mask_1_w = vis_batch['mask_1_warped'][idx]
        vis.save_gif(
            os.path.join(out_dir, f'{n:05d}_patch_1_2_mask.gif'),
            [to_u8(warped), to_u8(patch_2),
             np.tile((np.clip(mask_1_w, 0, 1) * 255).astype(np.uint8),
                     (1, 1, 3))])
        np.save(os.path.join(out_dir, f'{n:05d}_warped.npy'), warped)
        np.save(os.path.join(out_dir, f'{n:05d}_patch_2.npy'), patch_2)
        np.save(os.path.join(out_dir, f'{n:05d}_mask_1.npy'), mask_1_w)
        np.save(os.path.join(out_dir, f'{n:05d}_mask_2.npy'),
                vis_batch['mask_2'][idx])
        if 'pf' in vis_batch:
            np.save(os.path.join(out_dir, f'{n:05d}_pf.npy'),
                    vis_batch['pf'][idx])
        if 'image_2' in vis_batch:
            img2 = np.clip(vis_batch['image_2'][idx], 0, 255).astype(np.uint8)
            if img2.shape[-1] == 1:
                img2 = np.tile(img2, (1, 1, 3))
            corners = vis_batch['corners'][idx]
            img2 = vis.draw_rect(img2, corners - vis_batch['delta'][idx], 'b')
            img2 = vis.draw_rect(
                img2, corners - vis_batch['delta_hat'][idx], 'r')
            Image.fromarray(img2).save(
                os.path.join(out_dir, f'{n:05d}_image_vis.png'))


def dsac_generator(test_seed: int, iteration: int,
                   device='cpu') -> torch.Generator:
    """Generator of the DSAC (CPU) or RANSAC (``device``) draws for eval
    iteration ``iteration``."""
    return torch.Generator(device=device).manual_seed(
        pipeline.sample_seed(test_seed + 1, iteration))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the eval; returns the printed numbers plus the built model and
    the generated batches (for callers that check them further); under
    ``--multihost`` the MACEs are every rank's, the batches this rank's."""
    args = parse_args(argv)
    device = mesh.init_from_args(args)
    try:
        return _evaluate(args, device)
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()


def _evaluate(args: argparse.Namespace, device: torch.device
              ) -> Dict[str, Any]:
    main_rank = dist_util.is_main_process()
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
    if args.vis:
        built.test_pair_spec = dataclasses.replace(
            built.test_pair_spec,
            emit_images=tuple(sorted(set(built.test_pair_spec.emit_images)
                                     | {'image_2'})))
    model = built.model
    # The predict model: the backbone and, with score_cnn scoring, the
    # score CNN (the frozen loss extractor is not part of predict).
    init_gen = torch.Generator().manual_seed(INIT_SEED)
    backbones.init_weights(model.backbone, init_gen)
    if model.score_cnn is not None:
        backbones.init_weights(model.score_cnn, init_gen)
    if args.torch_ckpt:
        parts = load_torch_checkpoint(
            model, args.torch_ckpt, config['MODEL']['BACKBONE']['NAME'])
        print(f'Loaded reference torch checkpoint ({", ".join(parts)}) '
              f'from {args.torch_ckpt}')
    else:
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
    # This rank's iterations: a contiguous run (all of them in one process).
    iters = np.array_split(np.arange(num_iters),
                           dist_util.get_world_size())[dist_util.get_rank()]
    batches: List[Dict[str, torch.Tensor]] = []
    for it in iters:
        seeds = [pipeline.sample_seed(test_seed, it * batch_size + i)
                 for i in range(batch_size)]
        images = pipeline.take_images(pool, sample_to_pool[it].to(device))
        batches.append(pipeline.generate_pairs_per_sample(images, seeds, spec))

    maces, times, delta_hats = [], [], []
    gen_device = device if model.draws_on_device else torch.device('cpu')
    for it, batch in zip(iters, batches):
        start = time.perf_counter()
        delta_hat = model.predict(
            batch, generator=dsac_generator(test_seed, it, gen_device))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - start)
        diff = batch['delta'] - delta_hat
        maces.append(torch.linalg.vector_norm(diff, dim=-1).mean(-1).cpu())
        delta_hats.append(delta_hat)
    local = (torch.cat(maces).numpy() if maces
             else np.zeros(0, dtype=np.float32))
    # Rank order is sample order: the runs of iterations are contiguous.
    maces_np = np.concatenate(dist_util.all_gather(local))
    timed = times[1:] if len(times) > 1 else times
    per_batch_ms = float(np.mean(timed)) * 1000.0 if timed else float('nan')

    if args.log and main_rank:
        with open(args.log, 'a') as f:
            for it, m in enumerate(maces_np):
                f.write(f'{it},{float(m)}\n')
    if args.vis:
        for it, batch, delta_hat in zip(iters, batches, delta_hats):
            save_visualization(args.vis_dir, int(it), batch_size,
                               vis_outputs(model, batch, delta_hat))
        print(f'Visualization artifacts for {len(iters) * batch_size} '
              f'samples written to {args.vis_dir}')
    num_params = sum(p.numel() for p in model.backbone.parameters())
    if model.score_cnn is not None:
        num_params += sum(p.numel() for p in model.score_cnn.parameters())
    if main_rank:
        print(f'Number of params: {num_params}')
        print(f'Mean mace: {float(np.mean(maces_np))}')
        if not args.skip_timing:
            print(f'Mean model time: {per_batch_ms}')
    return {'num_params': num_params, 'mean_mace': float(np.mean(maces_np)),
            'maces': maces_np, 'per_batch_ms': per_batch_ms,
            'batch_size': batch_size, 'num_iters': num_iters,
            'test_seed': test_seed, 'model': model, 'batches': batches,
            'delta_hats': delta_hats,
            'built': built}


if __name__ == '__main__':
    main()
