"""The lower-precision control: the plain reference computed with TF32
allowed in cuBLAS and cuDNN (the nearest precision below the
configurations' float32) put in the program's place, against the
reference at float32, on the inputs a run of the cell would make from
the seed. The check has to find it not correct; the benchmark's own
runs never run it."""

from __future__ import annotations

import copy
import statistics

import torch

from benchmark.harness import checks, generators, inputs
from benchmark.harness.inputs import sub_seed
from benchmark.reference import step


def _ref(cfg, seed, device, tf32):
    generators._tf32(tf32)
    ref = step.build(copy.deepcopy(cfg['config']))
    ref.model.to(device)
    inputs.seeded_init(ref.model, sub_seed(seed, inputs.WEIGHTS))
    return ref


def train(cfg, traffic, seed, device):
    pool = inputs.make_image_pool(traffic['pool_size'],
                                  tuple(traffic['image_hw']),
                                  sub_seed(seed, inputs.POOL), device)
    outs = []
    for tf32 in (True, False):
        gens = (torch.Generator(device=device).manual_seed(
            sub_seed(seed, inputs.DRAWS)),
                torch.Generator().manual_seed(sub_seed(seed, inputs.DATAGEN)),
                torch.Generator().manual_seed(sub_seed(seed, inputs.DSAC)))
        ref = _ref(cfg, seed, device, tf32)
        outs.append(step.train_steps(ref, pool, traffic['batch'],
                                     traffic['checked_steps'], *gens))
        del ref
    generators._tf32(False)
    return {'numbers': checks.train_gaps(*outs),
            'readings': {'control_loss': outs[0]['loss'],
                         'reference_loss': outs[1]['loss']}}


def predict(cfg, traffic, seed, device):
    from benchmark.reference.data.pipeline import PairSpec
    data = cfg['config']['DATA']
    spec = PairSpec.from_transforms(data.get('TEST_TRANSFORM',
                                             data['TRANSFORMS']))
    pool = inputs.make_image_pool(traffic['pool_size'],
                                  tuple(traffic['image_hw']),
                                  sub_seed(seed, inputs.POOL), device)
    b = traffic['batch']
    pairs = inputs.patch_pairs(pool, traffic['distinct_batches'], b, spec,
                               sub_seed(seed, inputs.PAIRS))
    weights = generators._served_weights(cfg, seed, device, pairs)
    deltas = []
    for tf32 in (True, False):
        generators._tf32(tf32)
        ref = step.build(copy.deepcopy(cfg['config']))
        ref.model.to(device)
        ref.model.load_state_dict(weights)
        uniforms = step.serving_uniforms(ref, b,
                                         sub_seed(seed, inputs.SERVING))
        deltas.append([step.predict(ref, pairs['patch_1'][k],
                                    pairs['patch_2'][k], uniforms).cpu()
                       for k in range(traffic['distinct_batches'])])
    generators._tf32(False)
    gap = max(float((a - r).abs().max()) for a, r in zip(*deltas))
    scale = statistics.median(float(d.abs().max()) for d in deltas[1])
    return {'numbers': {'delta_gap_px': gap,
                        'delta_gap_rel': gap / max(scale, 1e-30)},
            'readings': {'reference_max_abs_delta_px': scale}}


KINDS = {'train_pool': train, 'predict_closed': predict}
