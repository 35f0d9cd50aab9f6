"""head_loss_ms.train: ms a step from the backbone's outputs to their
gradients: the head (DSAC), the loss and their backward (CUDA events)."""

from benchmark.harness import readers


def read(ctx):
    return readers.per_unit_ms(ctx, 'fwd1-head1') if 'steps' in ctx else None
