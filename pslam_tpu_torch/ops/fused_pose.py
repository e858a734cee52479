"""Fused pose-optimization edge terms: kernel K2 (port of
``pslam_tpu/ops/pallas_pose.py``).

``pose_terms(data, par)`` evaluates one LM iteration's point-edge terms at
one pose: H (6, 6), b (6,), the robust cost and chi2 for every edge. On CUDA
tensors it launches the hand-written kernel ``csrc/fused_pose.cu``; on CPU
tensors it runs the plain version (``solver/pose_opt._edge_terms`` +
``_gn_system``). There is no other path: a CUDA launch that fails raises.

Parameter packing (as in the JAX module):
    data: (8, E) f32 rows [X0, X1, X2, obs_u, obs_v, obs_ur, inv_sigma2,
          active] (world points; obs_ur < 0 marks mono edges)
    par:  (1, 128) f32 [T_cw row-major (16), fx, fy, cx, cy, bf, use_huber]
"""

from __future__ import annotations

import ctypes

import torch

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.ops import _build

# Kernel launches since import (or since a caller reset it to 0). The plain
# CPU path does not count.
LAUNCHES = 0

# The C interface of csrc/fused_pose.cu: function name -> argtypes.
ARGTYPES = {
    "pslam_fused_pose": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 5,
}

_c_fn = None


def _kernel():
    global _c_fn
    if _c_fn is None:
        _c_fn = _build.bind("fused_pose", ARGTYPES)["pslam_fused_pose"]
    return _c_fn


def pack_pose_data(po):
    """PoseObs -> the (8, E) data block (row 7 = po.valid; callers overwrite
    it per round)."""
    return torch.stack(
        [
            po.X_w[:, 0], po.X_w[:, 1], po.X_w[:, 2],
            po.obs[:, 0], po.obs[:, 1], po.obs[:, 2],
            po.inv_sigma2, po.valid.to(torch.float32),
        ],
        dim=0,
    )


def pose_param_tail(cam: Camera, use_huber: bool, device):
    """The pose-independent part of the parameter row: (112,) f32."""
    tail = torch.zeros(112, dtype=torch.float32)
    tail[:6] = torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                             1.0 if use_huber else 0.0])
    return tail.to(device)


def pack_pose_params(T, tail):
    """Pose (4, 4) + ``pose_param_tail`` -> the (1, 128) parameter row."""
    return torch.cat([T.reshape(16), tail])[None, :]


def pose_terms_plain(data, par):
    """Plain PyTorch version: the pose solver's own edge terms + normal
    equations, with the camera and pose decoded from ``par``."""
    from pslam_tpu_torch.solver.pose_opt import PoseObs, _edge_terms, _gn_system

    p = par.reshape(-1)
    fx, fy, cx, cy, bf, hub = p[16:22].tolist()
    cam = Camera(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf)
    T = p[:16].reshape(4, 4)
    po = PoseObs(X_w=data[0:3].T, obs=data[3:6].T, inv_sigma2=data[6],
                 valid=data[7] > 0.5)
    chi2, w_eff, r, J, row_mask, cost = _edge_terms(
        cam, T, po, hub > 0.5, data[7]
    )
    H, b = _gn_system(w_eff, r, J, row_mask)
    return H, b, cost, chi2


def pose_terms(data, par):
    """data (8, E) f32, par (1, 128) f32 -> (H (6, 6), b (6,), cost (),
    chi2 (E,)). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    global LAUNCHES
    if data.device.type == "cpu":
        return pose_terms_plain(data, par)
    E = data.shape[1]
    _build.check_cuda(data, "data", torch.float32, (8, E))
    _build.check_cuda(par, "par", torch.float32, (1, 128))
    dev = data.device
    H = torch.empty((6, 6), dtype=torch.float32, device=dev)
    b = torch.empty(6, dtype=torch.float32, device=dev)
    cost = torch.empty(1, dtype=torch.float32, device=dev)
    chi2 = torch.empty(E, dtype=torch.float32, device=dev)
    rc = _kernel()(
        data.data_ptr(), par.data_ptr(), E, H.data_ptr(), b.data_ptr(),
        cost.data_ptr(), chi2.data_ptr(), _build.stream_ptr(data),
    )
    if rc != 0:
        raise RuntimeError(f"fused_pose kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return H, b, cost[0], chi2
