"""Data parallelism over ranks: ``dist_util`` (the reference's
torch.distributed helpers) and ``mesh`` (process group, batch shards,
statistic and gradient sums)."""
