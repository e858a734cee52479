"""Typed configs, metrics (ATE), timers."""

from pslam_tpu_torch.utils.config import SlamConfig, Capacities  # noqa: F401
from pslam_tpu_torch.utils.metrics import ate_rmse, align_se3  # noqa: F401
