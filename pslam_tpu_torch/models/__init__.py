"""Struct-of-arrays host map (numpy)."""

from pslam_tpu_torch.models.map_state import MapState  # noqa: F401
