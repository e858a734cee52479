"""Robust kernels and chi-square gates (port of ``pslam_tpu/solver/robust.py``).

g2o Huber kernels with fixed deltas and per-round chi2 outlier gates
(Optimizer.cc:291-299, 699-706): sqrt(5.991) for 2-dof mono edges,
sqrt(7.815) for 3-dof stereo edges, applied as IRLS weights.
"""

import torch

# 95% chi-square quantiles used throughout the reference.
CHI2_MONO = 5.991  # 2 dof
CHI2_STEREO = 7.815  # 3 dof


def huber_weight(chi2, delta):
    """IRLS weight for the Huber kernel on e = sqrt(chi2) with threshold
    ``delta``: 1 inside, delta / e outside."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)
