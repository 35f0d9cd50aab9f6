"""One step of the port's contrastive pretexts (``bihome_torch.
pretrain_aux``: gradcl and gradpdscl) against JAX's loss composed from
``tools/pretrain_aux.py``'s own functions, the same weights and injected
draws, float32, as ``test_torch_pretrain_step.py`` holds the others, with
its tolerances. gradcl runs every extra term: the rich target, the rex-0
InfoNCE (``--cl_fine_weight``), hard negatives (``--cl_hard_beta``) and
the basin term (``--basin_weight``, whose jittered view warps by K3's
plain version here); gradpdscl runs with the PDS distortion of both
copies, at layer 1 and at layer 2 (stride 8, 128 channels). The layer-2
case takes seed 1: seeds 0, 2 and 3 put a ReLU input of layer 2 within
float32 rounding of its kink (one tensor reads 5e-3 to 8.5e-3), seeds 1
and 4 at most 8.3e-6.
"""

import pytest
import torch

from tests import torch_pretrain_oracle as oracle
from tests.test_torch_pretrain_step import check_step


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """torch's CPU ops on one thread while this file runs: its CPU work is
    small, and the parallel test run's workers then do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# case -> (pretext settings, seed)
CASES = {
    'gradcl': (dict(rich_target=True, cl_fine_weight=0.3, cl_hard_beta=0.5,
                    basin_weight=0.5), 0),
    'gradpdscl': ({}, 0),
    'gradpdscl layers 2': (dict(layers=2), 1),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_contrastive_step_matches_jax(case):
    settings, seed = CASES[case]
    check_step(oracle.pretext(case.split()[0], **settings), seed)
