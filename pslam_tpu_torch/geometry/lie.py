"""Batched SO3 / SE3 Lie-group operations in PyTorch.

Port of ``pslam_tpu/geometry/lie.py``: SO3, SE3 and the Sim3 group of loop
closing. Same conventions:

- SE3 elements are homogeneous ``(..., 4, 4)`` matrices; composition is a
  matmul and batching is free.
- Tangent vectors are ``xi = [omega(3), upsilon(3)]`` (g2o ``SE3Quat::exp``
  ordering); updates are left-multiplicative ``T <- exp(xi) @ T``.
- Sim3 elements are ``Sim3(s, R, t)`` tuples, ``x -> s R x + t``, with
  tangent ``[omega(3), upsilon(3), sigma]``.

All functions broadcast over leading batch dimensions and are safe at the
small-angle limit (Taylor switches via ``torch.where`` with safe operands).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8

# Taylor switch for the trig ratio helpers (see the JAX module: at x=1e-4 in
# f32, 1-cos(x) evaluates to exactly 0; with the series carried to x^4 the
# error at the 1e-2 switch point is ~1e-16).
_TAYLOR_SWITCH = 1e-2


def _safe_norm(v):
    """L2 norm that stays finite and differentiable at v = 0."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)


def _sinc(x):
    """sin(x)/x, f32-safe at 0."""
    small = torch.abs(x) < _TAYLOR_SWITCH
    safe = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 1.0 - x2 / 6.0 + x2 * x2 / 120.0, torch.sin(safe) / safe)


def _cosc(x):
    """(1 - cos(x)) / x^2, f32-safe at 0."""
    small = torch.abs(x) < _TAYLOR_SWITCH
    safe = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(
        small,
        0.5 - x2 / 24.0 + x2 * x2 / 720.0,
        (1.0 - torch.cos(safe)) / (safe * safe),
    )


def _sincc(x):
    """(x - sin(x)) / x^3, f32-safe at 0."""
    small = torch.abs(x) < _TAYLOR_SWITCH
    safe = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(
        small,
        1.0 / 6.0 - x2 / 120.0 + x2 * x2 / 5040.0,
        (safe - torch.sin(safe)) / (safe**3),
    )


def _eye_like(K, n: int):
    return torch.eye(n, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w):
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    theta = _safe_norm(w)
    K = so3_hat(w)
    K2 = K @ K
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye_like(K, 3) + a * K + b * K2


def rotation_to_quaternion(R):
    """(..., 3, 3) -> (..., 4) unit quaternion [w, x, y, z], w >= 0.

    Branchless Shepperd's method: all four candidate constructions, keyed by
    the largest of (trace, R00, R11, R22)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    qw = torch.stack([1.0 + tr, r21 - r12, r02 - r20, r10 - r01], dim=-1)
    qx = torch.stack([r21 - r12, 1.0 + r00 - r11 - r22, r01 + r10, r02 + r20], dim=-1)
    qy = torch.stack([r02 - r20, r01 + r10, 1.0 + r11 - r00 - r22, r12 + r21], dim=-1)
    qz = torch.stack([r10 - r01, r02 + r20, r12 + r21, 1.0 + r22 - r00 - r11], dim=-1)

    scores = torch.stack([tr, r00, r11, r22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    sel = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cand, -2, sel)[..., 0, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    return q * sign


def so3_log(R):
    """(..., 3, 3) rotation -> (..., 3) axis-angle. Safe near 0 and pi."""
    q = rotation_to_quaternion(R)
    qw = torch.clamp(q[..., 0], -1.0, 1.0)
    qv = q[..., 1:]
    norm_qv = _safe_norm(qv)
    theta = 2.0 * torch.atan2(norm_qv, qw)
    small = norm_qv < 1e-6
    scale = torch.where(
        small,
        2.0 + theta * theta / 12.0,
        theta / torch.where(small, torch.ones_like(norm_qv), norm_qv),
    )
    return qv * scale[..., None]


def _so3_left_jacobian(w):
    """V such that t = V @ upsilon in se3_exp. (..., 3) -> (..., 3, 3)."""
    theta = _safe_norm(w)
    K = so3_hat(w)
    K2 = K @ K
    b = _cosc(theta)[..., None, None]
    c = _sincc(theta)[..., None, None]
    return _eye_like(K, 3) + b * K + c * K2


def _so3_left_jacobian_inv(w):
    theta = _safe_norm(w)
    K = so3_hat(w)
    K2 = K @ K
    # 1/theta^2 (1 - theta sin / (2(1-cos))): the generic form cancels
    # catastrophically in f32 below theta~1e-3, so switch to the series at 0.1.
    small = theta < 0.1
    safe = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta * theta
    coef = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
        (1.0 - safe * torch.sin(safe) / (2.0 * (1.0 - torch.cos(safe)))) / (safe * safe),
    )
    return _eye_like(K, 3) - 0.5 * K + coef[..., None, None] * K2


def se3_exp(xi):
    """(..., 6) tangent [omega, upsilon] -> (..., 4, 4) SE3 matrix."""
    w = xi[..., :3]
    u = xi[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", V, u)
    return se3_from_Rt(R, t)


def se3_log(T):
    """(..., 4, 4) -> (..., 6) tangent [omega, upsilon]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    Vinv = _so3_left_jacobian_inv(w)
    u = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, u], dim=-1)


def se3_from_Rt(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # [0, 0, 0, 1] made on the device: a host tensor would be a copy that
    # waits, and that a CUDA graph capture refuses.
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])], dim=-1)[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def se3_identity(batch_shape=(), dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch_shape) + (4, 4))


def se3_R(T):
    return T[..., :3, :3]


def se3_t(T):
    return T[..., :3, 3]


def se3_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_from_Rt(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T, X):
    """Apply SE3 ``T`` (..., 4, 4) to points ``X`` (..., N, 3) or (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if X.ndim == T.ndim - 1:  # single point per batch element
        return torch.einsum("...ij,...j->...i", R, X) + t
    return torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]


def rotate_points(T, X):
    R = T[..., :3, :3]
    if X.ndim == T.ndim - 1:
        return torch.einsum("...ij,...j->...i", R, X)
    return torch.einsum("...ij,...nj->...ni", R, X)


# --------------------------------------------------------------------------
# Sim3
# --------------------------------------------------------------------------


class Sim3(NamedTuple):
    """Similarity transform x -> s * R @ x + t (g2o sim3.h semantics)."""

    s: torch.Tensor  # (...,)
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


def sim3_identity(batch_shape=(), dtype=torch.float32, device=None):
    b = tuple(batch_shape)
    return Sim3(
        s=torch.ones(b, dtype=dtype, device=device),
        R=torch.eye(3, dtype=dtype, device=device).expand(b + (3, 3)),
        t=torch.zeros(b + (3,), dtype=dtype, device=device),
    )


def sim3_compose(a: Sim3, b: Sim3) -> Sim3:
    """(a o b)(x) = a(b(x))."""
    return Sim3(
        s=a.s * b.s,
        R=a.R @ b.R,
        t=a.s[..., None] * torch.einsum("...ij,...j->...i", a.R, b.t) + a.t,
    )


def sim3_inverse(g: Sim3) -> Sim3:
    Rt = g.R.transpose(-1, -2)
    s_inv = 1.0 / g.s
    return Sim3(s=s_inv, R=Rt, t=-s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, g.t))


def sim3_transform_points(g: Sim3, X):
    if X.ndim == g.R.ndim - 1:
        return g.s[..., None] * torch.einsum("...ij,...j->...i", g.R, X) + g.t
    return g.s[..., None, None] * torch.einsum("...ij,...nj->...ni", g.R, X) + g.t[..., None, :]


def sim3_from_se3(T, s=None):
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return Sim3(s=s, R=T[..., :3, :3], t=T[..., :3, 3])


def sim3_to_se3(g: Sim3):
    """Project Sim3 to SE3 by dividing the translation by the scale (the
    reference's loop-correction convention, LoopClosing.cc CorrectLoop)."""
    return se3_from_Rt(g.R, g.t / g.s[..., None])


def sim3_exp(zeta) -> Sim3:
    """(..., 7) tangent [omega(3), upsilon(3), sigma] -> Sim3.

    t = W @ u with W = A*K + B*K^2 + C*I (Ethan Eade / g2o sim3); the
    coefficients switch to their series where sigma or theta is below 1e-6,
    as the JAX package does."""
    w = zeta[..., :3]
    u = zeta[..., 3:6]
    sigma = zeta[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(w)
    theta = _safe_norm(w)
    K = so3_hat(w)
    K2 = K @ K
    eye = _eye_like(K, 3)

    eps = 1e-6
    one = torch.ones_like(sigma)
    small_sigma = torch.abs(sigma) < eps
    small_theta = theta < eps
    sigma_safe = torch.where(small_sigma, one, sigma)
    theta_safe = torch.where(small_theta, one, theta)

    C = torch.where(small_sigma, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sigma_safe)

    a_gen = s * torch.sin(theta_safe)
    b_gen = s * torch.cos(theta_safe)
    c2 = theta_safe * theta_safe
    s2 = sigma_safe * sigma_safe
    denom = s2 + c2
    A_gen = (a_gen * sigma_safe + (1.0 - b_gen) * theta_safe) / (theta_safe * denom)
    B_gen = (C - ((b_gen - 1.0) * sigma_safe + a_gen * theta_safe) / denom) / c2

    A_s0 = _cosc(theta)
    B_s0 = _sincc(theta)

    A_t0 = ((sigma_safe - 1.0) * s + 1.0) / s2
    B_t0 = (s * 0.5 * s2 + s - 1.0 - sigma_safe * s) / (s2 * sigma_safe)

    A_both = 0.5 + sigma / 6.0
    B_both = 1.0 / 6.0 + sigma / 24.0

    both = small_sigma & small_theta
    A = torch.where(both, A_both, torch.where(small_sigma, A_s0, torch.where(small_theta, A_t0, A_gen)))
    B = torch.where(both, B_both, torch.where(small_sigma, B_s0, torch.where(small_theta, B_t0, B_gen)))

    W = A[..., None, None] * K + B[..., None, None] * K2 + C[..., None, None] * eye
    return Sim3(s=s, R=R, t=torch.einsum("...ij,...j->...i", W, u))


def sim3_log(g: Sim3):
    """Sim3 -> (..., 7) tangent, the inverse of sim3_exp: W's columns come
    from exp of the basis vectors, then u solves W u = t."""
    sigma = torch.log(g.s)
    w = so3_log(g.R)
    basis = torch.eye(3, dtype=w.dtype, device=w.device)
    cols = []
    for i in range(3):
        z = torch.cat([w, basis[i].expand(w.shape), sigma[..., None]], dim=-1)
        cols.append(sim3_exp(z).t)
    W = torch.stack(cols, dim=-1)
    u = torch.linalg.solve(W, g.t[..., None])[..., 0]
    return torch.cat([w, u, sigma[..., None]], dim=-1)
