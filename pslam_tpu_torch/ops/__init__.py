"""Device ops: image pyramid, FAST/rBRIEF extraction, line detection,
descriptor matching, triangulation, BoW, and the two hand-written CUDA
kernels (``fused_match``, ``fused_pose``) with their plain PyTorch
versions."""

from pslam_tpu_torch.ops.image import (  # noqa: F401
    build_pyramid,
    gaussian_blur,
    PYR_LEVELS,
    PYR_SCALE,
)
from pslam_tpu_torch.ops.fast import fast_score  # noqa: F401
from pslam_tpu_torch.ops.orb import OrbFeatures, OrbConfig, extract_orb  # noqa: F401
from pslam_tpu_torch.ops.match import (  # noqa: F401
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
)
