"""The host-to-card pieces of the file-fed training path, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX.

* ``train.StreamFeed`` copies each host batch to the card through pinned
  memory, ``non_blocking``, in the loader's order, bytes unchanged.
* ``Optimizer.load_state_dict`` and ``CheckPointer.load`` put the Adam
  moments and the weights of a CPU-written checkpoint on the card, and
  the next update equals the one of the optimizer that wrote it.
"""

import numpy as np
import pytest
import torch

from bihome_torch import train
from bihome_torch.data import datasets
from bihome_torch.training import checkpoint
from bihome_torch.training.train_state import Optimizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def test_stream_feed_pinned_copy_keeps_order_and_bytes(cuda):
    ds = datasets.SyntheticDataset(num_images=6, image_size=(64, 48), seed=3)
    want = [ds.pool[i] for i in datasets.EpochSampler(
        6, 8, random_seed=5).epoch_indices()]
    feed = train.StreamFeed(datasets.BatchLoader(ds, 2, 8, random_seed=5),
                            cuda)
    got = list(feed.epoch())
    assert len(got) == 4
    for k, batch in enumerate(got):
        assert batch.device.type == 'cuda' and batch.dtype == torch.uint8
        np.testing.assert_array_equal(batch.cpu().numpy(),
                                      np.stack(want[2 * k:2 * k + 2]))


def test_checkpoint_written_on_cpu_resumes_on_the_card(cuda, tmp_path):
    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = torch.nn.Linear(3, 2)

    torch.manual_seed(0)
    cpu_model = Model()
    opt = Optimizer(list(cpu_model.parameters()), lr=1e-2, milestones=[2])
    x = torch.randn(4, 3)

    def step(model, optimizer):
        optimizer.zero_grad()
        model.backbone(x.to(next(model.parameters()).device)).square(
        ).sum().backward()
        return optimizer.step()

    step(cpu_model, opt)
    step(cpu_model, opt)
    checkpoint.CheckPointer(str(tmp_path)).save(2, cpu_model, opt)
    card_model = Model().to(cuda)
    card_opt = Optimizer(list(card_model.parameters()), lr=1e-2,
                         milestones=[2])
    _, start = checkpoint.CheckPointer(str(tmp_path)).load(card_model,
                                                           card_opt)
    assert start == 2 and card_opt.count == 2
    for p in card_model.parameters():
        assert card_opt.adam.state[p]['exp_avg'].device.type == 'cuda'
    assert step(cpu_model, opt) == step(card_model, card_opt) == 1e-3
    for a, b in zip(cpu_model.parameters(), card_model.parameters()):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=1e-7)
