"""pslam_tpu_torch — the PyTorch/CUDA port of pslam_tpu.

The port mirrors ``pslam_tpu``'s layout (``geometry``, ``ops``, ``solver``,
``models``, ``pipeline``, ``parallel``, ``io``, ``apps``, ``utils``) module
for module, so each function's counterpart is easy to find. It imports torch
and numpy only.

The port does what ``pslam_tpu`` does: RGB-D, stereo and monocular tracking
through ``SlamSystem`` with points, map lines and structural lines (LILs),
local mapping and the Schur local BA, BoW relocalization, loop closing with
the Sim3 essential graph and global BA (the default ``SlamConfig()``),
localization-only mode, pipelined tracking, checkpoints, the TUM IO and the
``apps.rgbd_tum`` CLI, and the edge-sharded solvers of ``parallel`` over
``torch.distributed`` (``distributed=True``). The two TPU Pallas kernels are
hand-written CUDA kernels for Hopper (``csrc/``), launched by
``ops/fused_match.py`` and ``ops/fused_pose.py``; on CPU tensors their
wrappers run the plain PyTorch versions.

Device handling: ``SlamSystem(cfg)`` and the app run on the CUDA card and
raise ``RuntimeError`` where there is none; ``SlamSystem(cfg, device="cpu")``
(``--device cpu``) asks for the CPU. Every other function computes on the
device of the tensors it is given.
"""

import torch as _torch

# Counterpart of pslam_tpu's jax_default_matmul_precision="highest": pose
# chains and the Schur assembly need full f32. TF32 keeps ~3 decimal digits
# and drifts composed rotations off SO(3).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
