"""pslam_tpu_torch — the PyTorch/CUDA port of pslam_tpu.

The port mirrors ``pslam_tpu``'s layout (``geometry``, ``ops``, ``solver``,
``models``, ``pipeline``, ``io``, ``utils``) module for module, so each
function's counterpart is easy to find. It imports torch and numpy only.

The port covers RGB-D tracking with points, map lines and structural lines
(BASELINE configs 1-3, ``use_bow=False, use_loop_closing=False``) driven
through ``SlamSystem.track_rgbd``. The two TPU Pallas kernels on that path
are hand-written CUDA kernels for Hopper (``csrc/``), launched by
``ops/fused_match.py`` and ``ops/fused_pose.py``; on CPU tensors their
wrappers run the plain PyTorch versions.

Device handling: ``SlamSystem(cfg)`` runs on the CUDA card and raises
``RuntimeError`` where there is none; ``SlamSystem(cfg, device="cpu")`` asks
for the CPU. Every other function computes on the device of the tensors it
is given.
"""

import torch as _torch

# Counterpart of pslam_tpu's jax_default_matmul_precision="highest": pose
# chains and the Schur assembly need full f32. TF32 keeps ~3 decimal digits
# and drifts composed rotations off SO(3).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
