"""Estimation core: robust Levenberg-Marquardt for pose-only optimization,
the Schur-complement local BA with point and structural-line landmarks,
Sim3 optimization and the essential graph, Horn/PnP RANSACs and the
monocular two-view initializer."""

from pslam_tpu_torch.solver.robust import (  # noqa: F401
    huber_weight,
    CHI2_MONO,
    CHI2_STEREO,
)
from pslam_tpu_torch.solver.reproj import (  # noqa: F401
    mono_residual_jac,
    stereo_residual_jac,
)
from pslam_tpu_torch.solver.pose_opt import pose_optimization, PoseObs  # noqa: F401
from pslam_tpu_torch.solver.local_ba import local_bundle_adjustment, BAProblem  # noqa: F401
