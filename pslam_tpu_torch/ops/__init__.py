"""Device ops: image pyramid, FAST/rBRIEF extraction, descriptor matching,
triangulation, and the two hand-written CUDA kernels (fused_match,
fused_pose) with their plain PyTorch versions."""
