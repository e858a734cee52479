"""Dataset IO: TUM/ICL loaders, synthetic RGB-D scenes, checkpoints."""
