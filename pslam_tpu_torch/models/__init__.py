"""Struct-of-arrays host map (numpy; replaces reference L4: Map, MapPoint,
KeyFrame, covisibility graph)."""

from pslam_tpu_torch.models.map_state import MapState  # noqa: F401
