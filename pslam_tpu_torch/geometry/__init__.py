"""SO3 / SE3 / Sim3 Lie groups and camera models, batched over leading dimensions."""

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
    Sim3,
    sim3_identity,
    sim3_compose,
    sim3_inverse,
    sim3_transform_points,
    sim3_from_se3,
    sim3_to_se3,
    sim3_exp,
    sim3_log,
)
from pslam_tpu_torch.geometry.camera import (  # noqa: F401
    Camera,
    project,
    project_stereo,
    backproject,
    undistort_points,
    in_image,
)
