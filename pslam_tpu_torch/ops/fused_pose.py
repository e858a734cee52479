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

``lm_step`` is the rest of one Levenberg-Marquardt iteration of the pose
solve (``solver/pose_opt.pose_optimization``): it takes in the evaluation K2
just wrote, accepts or rejects it, updates lambda and writes the next
proposal into the parameter row the next K2 call reads. On CUDA tensors it
launches the second kernel of ``csrc/fused_pose.cu``; on CPU tensors it runs
``lm_step_plain``. Its state is one row of ``lm_rows``:
    state: (128,) f32 [T row-major (16), lambda, cost, H (36), b (6), first,
           0...]; first != 0 marks the round's first evaluation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pslam_tpu_torch.geometry import Camera, se3_exp
from pslam_tpu_torch.ops import _build

# Kernel launches since import (or since a caller reset it to 0): K2 in
# LAUNCHES, the LM step in LM_LAUNCHES. The plain CPU path does not count.
LAUNCHES = 0
LM_LAUNCHES = 0

# The C interface of csrc/fused_pose.cu: function name -> argtypes.
ARGTYPES = {
    "pslam_fused_pose": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 5,
    "pslam_lm_step": [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p],
}

# The LM state row (csrc/fused_pose.cu kLm*).
LM_T, LM_LAM, LM_COST, LM_H, LM_B, LM_FIRST = 0, 16, 17, 18, 54, 60
LM_LAMBDA0 = 1e-4

_c_fns = None


def _kernel(name: str = "pslam_fused_pose"):
    global _c_fns
    if _c_fns is None:
        _c_fns = _build.bind("fused_pose", ARGTYPES)
    return _c_fns[name]


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


@functools.lru_cache(maxsize=None)
def _lm_template(fx, fy, cx, cy, bf, device: str):
    rows = torch.zeros((3, 128), dtype=torch.float32)
    rows[0, LM_LAM] = LM_LAMBDA0
    rows[0, LM_FIRST] = 1.0
    for r, hub in ((1, 1.0), (2, 0.0)):
        rows[r, 16:22] = torch.tensor([fx, fy, cx, cy, bf, hub])
    return rows.to(device)


def lm_rows(cam: Camera, T):
    """(3, 128) f32 on T's device: row 0 a fresh LM state at pose T (lambda
    1e-4, the first-evaluation flag set), rows 1 and 2 the parameter rows at
    T with Huber on and off. The pose-independent part is built once per
    camera and device."""
    rows = _lm_template(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, str(T.device)).clone()
    rows[:, :16] = T.reshape(16)
    return rows


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
    rc = _kernel("pslam_fused_pose")(
        data.data_ptr(), par.data_ptr(), E, H.data_ptr(), b.data_ptr(),
        cost.data_ptr(), chi2.data_ptr(), _build.stream_ptr(data),
    )
    if rc != 0:
        raise RuntimeError(f"fused_pose kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return H, b, cost[0], chi2


def _damped_solve(H, b, lam):
    """Damped 6x6 solve (no host sync: solve_ex does not check ``info``)."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    Hd = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye
    return torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0]


def lm_step_plain(state, H_new, b_new, cost_new, par_in, par_out, lil=None, close=False):
    """Plain PyTorch version of one LM step: the body of the pose solve's
    LM loop, on the state row and parameter rows in place."""
    first = bool(state[LM_FIRST] != 0)
    if lil is not None:
        H_new, b_new, cost_new = H_new + lil[0], b_new + lil[1], cost_new + lil[2]
    T = state[LM_T:LM_T + 16].reshape(4, 4).clone()
    lam = state[LM_LAM].clone()
    cost = state[LM_COST].clone()
    H = state[LM_H:LM_H + 36].reshape(6, 6).clone()
    b = state[LM_B:LM_B + 6].clone()
    if first:
        H, b, cost = H_new, b_new, cost_new
    else:
        T_new = par_in[0, :16].reshape(4, 4)
        accept = cost_new < cost
        T = torch.where(accept, T_new, T)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        cost = torch.where(accept, cost_new, cost)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
    if close:
        out = T
        lam = torch.full_like(lam, LM_LAMBDA0)
    else:
        dx = _damped_solve(H, b, lam)
        out = se3_exp(dx) @ T
    state[LM_T:LM_T + 16] = T.reshape(16)
    state[LM_LAM] = lam
    state[LM_COST] = cost
    state[LM_H:LM_H + 36] = H.reshape(36)
    state[LM_B:LM_B + 6] = b
    state[LM_FIRST] = 1.0 if close else 0.0
    par_out[0, :16] = out.reshape(16)
    if close:
        par_in[0, :16] = T.reshape(16)


def lm_step(state, H_new, b_new, cost_new, par_in, par_out, lil=None, close=False):
    """One LM iteration of the pose solve between two K2 calls, in place.

    Takes in the evaluation at ``par_in``'s pose (K2's H (6, 6), b (6,), cost
    (), plus ``lil`` = the LIL terms (H, b, cost) at the same pose, or None):
    the round's first evaluation is taken as it is; after it
    ``cost_new < cost`` accepts (a NaN rejects), and lambda halves on accept,
    quadruples on reject and is clamped to [1e-10, 1e6]. Then it writes the
    damped step's pose ``se3_exp(dx) @ T`` into ``par_out``; with ``close``
    (the round's last step) it writes the round's pose T into ``par_out``
    and ``par_in`` instead, and resets lambda and the flag for the next
    round. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    global LM_LAUNCHES
    if state.device.type == "cpu":
        return lm_step_plain(state, H_new, b_new, cost_new, par_in, par_out, lil, close)
    f32 = torch.float32
    _build.check_cuda(state, "state", f32, (128,))
    _build.check_cuda(H_new, "H_new", f32, (6, 6))
    _build.check_cuda(b_new, "b_new", f32, (6,))
    _build.check_cuda(cost_new, "cost_new", f32, ())
    _build.check_cuda(par_in, "par_in", f32, (1, 128))
    _build.check_cuda(par_out, "par_out", f32, (1, 128))
    if lil is None:
        lil_ptrs = [None, None, None]
    else:
        for name, t, shape in zip(("H_lil", "b_lil", "cost_lil"), lil, ((6, 6), (6,), ())):
            _build.check_cuda(t, name, f32, shape)
        lil_ptrs = [t.data_ptr() for t in lil]
    rc = _kernel("pslam_lm_step")(
        H_new.data_ptr(), b_new.data_ptr(), cost_new.data_ptr(), *lil_ptrs,
        par_in.data_ptr(), state.data_ptr(), par_out.data_ptr(), int(close),
        _build.stream_ptr(state),
    )
    if rc != 0:
        raise RuntimeError(f"LM step kernel launch failed: CUDA error {rc}")
    LM_LAUNCHES += 1
