"""SE3 Lie group and camera models, batched over leading dimensions."""

from pslam_tpu_torch.geometry.lie import (  # noqa: F401
    so3_hat,
    so3_exp,
    so3_log,
    se3_exp,
    se3_log,
    se3_inverse,
    se3_identity,
    se3_from_Rt,
    se3_R,
    se3_t,
    transform_points,
    rotate_points,
    rotation_to_quaternion,
)
from pslam_tpu_torch.geometry.camera import (  # noqa: F401
    Camera,
    project,
    project_stereo,
    backproject,
    undistort_points,
    in_image,
)
