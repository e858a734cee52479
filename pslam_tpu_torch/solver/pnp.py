"""Batched 2D-3D pose RANSAC (PnP) for depth-sparse relocalization (port of
``pslam_tpu/solver/pnp.py``).

The uv-only fallback beside the 3D-3D Horn RANSAC (solver/horn.py), in the
role of the reference's EPnP RANSAC (src/PnPsolver.cc:165-477): every trial
solves a 6-point DLT for P = [R|t] in normalized camera coordinates, projects
all candidates and counts reprojection inliers; the best trial wins (first on
ties). The LM pose optimization downstream polishes the winner.

The hypotheses come in two steps, as in solver/horn.py: ``pnp_draws`` draws
(n_trials, 6) uniforms from a CPU ``torch.Generator``; ``pnp_sample_indices``
turns them into indices drawn uniformly, with replacement, among the valid
entries, on the device; ``pnp_ransac_2d3d`` solves from the indices.
"""

from __future__ import annotations

import torch

from pslam_tpu_torch.geometry import Camera

N_SAMPLE = 6  # DLT minimal-ish sample (12 equations for 11 DoF)


def pnp_draws(seed: int, n_trials: int, device):
    """(n_trials, N_SAMPLE) uniform [0, 1) draws on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.rand((n_trials, N_SAMPLE), generator=g).to(device)


def pnp_sample_indices(u, valid):
    """Uniforms (T, S) -> indices (T, S) uniform over the valid entries (over
    all entries when none is valid), without a host read."""
    N = valid.shape[0]
    c = torch.cumsum(valid.to(torch.int64), 0)
    n = c[-1]
    rank = torch.clamp((u * n.to(u.dtype)).to(torch.int64), max=n - 1)
    idx = torch.searchsorted(c, rank + 1)
    anywhere = torch.clamp((u * N).to(torch.int64), max=N - 1)
    return torch.where(n > 0, idx, anywhere)


def _dlt_pose(X, x):
    """Batched DLT: X (T, S, 3) world points, x (T, S, 2) normalized image
    coordinates -> (T, 4, 4) T_cw with R projected onto SO(3)."""
    T_, S = X.shape[:2]
    ones = torch.ones((T_, S, 1), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones], dim=-1)  # (T, S, 4)
    zero = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zero, -x[..., :1] * Xh], dim=-1)
    rows_v = torch.cat([zero, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=1)  # (T, 2S, 12)
    # Null space: the smallest eigenvector of A^T A (12x12 symmetric).
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = V[..., :, 0].reshape(T_, 3, 4)
    s = torch.linalg.vector_norm(P[:, 2, :3], dim=-1)
    P = P / torch.where(s > 1e-12, s, torch.ones_like(s))[:, None, None]
    # Positive depth for the sample majority fixes the projective sign.
    z = torch.einsum("tsj,tj->ts", Xh, P[:, 2])
    P = P * torch.sign(torch.sum(torch.sign(z), dim=1) + 0.5)[:, None, None]
    M = P[:, :, :3]
    U, _, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    T = torch.eye(4, dtype=X.dtype, device=X.device).repeat(T_, 1, 1)
    T[:, :3, :3] = U @ D @ Vt
    T[:, :3, 3] = P[:, :, 3]
    return T


def pnp_ransac_2d3d(
    cam: Camera,
    X_w,  # (N, 3) world points
    uv,  # (N, 2) observed pixels
    valid,  # (N,) bool
    idx,  # (n_trials, N_SAMPLE) sample indices
    px_th: float = 4.0,
):
    """Fixed-budget PnP RANSAC over the given samples. Returns (T_cw (4, 4),
    inlier (N,), n_inliers) (PnPsolver::iterate's role, PnPsolver.cc:165)."""
    x_n = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    Ts = _dlt_pose(X_w[idx], x_n[idx])  # (T, 4, 4)
    Xc = torch.einsum("tij,nj->tni", Ts[:, :3, :3], X_w) + Ts[:, None, :3, 3]
    z = Xc[..., 2]
    zs = torch.clamp(z, min=1e-9)
    u = cam.fx * Xc[..., 0] / zs + cam.cx
    v = cam.fy * Xc[..., 1] / zs + cam.cy
    err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = (err2 <= px_th**2) & (z > 0.05) & valid[None, :]
    score = torch.sum(inl.to(torch.int32), dim=1)
    best = torch.argmax(score)
    return Ts[best], inl[best], score[best]
