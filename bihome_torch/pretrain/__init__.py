"""The extractor's pretext training: the targets and losses
(:mod:`bihome_torch.pretrain.targets`); the entry point is
``python -m bihome_torch.pretrain_aux``."""
