"""3D line fitting from depth samples along 2D segments, fully batched (port
of ``pslam_tpu/ops/line3d.py``).

Replaces Frame::isLineGood (reference src/Frame.cc:662-750) and the per-line
RANSAC of LINEextractor::extract3dline_mahdist
(add_src/LineExtractor.cpp:216-323) as the JAX package does:

- ``N_SAMPLES`` equally spaced depth samples per segment, holes masked;
- per-sample whitening A = diag(1, 1, 1/sigma_z) J0^-1 (compPt3dCov /
  depthStdDev, LineExtractor.cpp:27-95), Mahalanobis point-to-line gate 3.0;
- RANSAC as ``N_TRIALS`` fixed candidate pairs in parallel (the pair table is
  the JAX package's, built with numpy from the same seed), each gated by the
  verify3dLine support spread (10 cells, >= 70% occupied);
- one PCA refit (power iteration) + re-selection; endpoints = extremal
  inlier projections; >= 5 valid samples and a 0.02 m extent (Frame.cc:736).

The JAX package's one-hot cell-occupancy test becomes a scatter of booleans.
"""

from __future__ import annotations

import numpy as np
import torch

from pslam_tpu_torch.geometry import Camera

N_SAMPLES = 24
N_TRIALS = 16
MIN_PTS = 5  # reference: pts3d.size() < 5 -> no line (Frame.cc:714)
MAH_THRESH = 3.0
MIN_LEN_3D = 0.02


def depth_std(z):
    """Kinect-style depth noise model (depthStdDev, LineExtractor.cpp:27)."""
    return torch.clamp(0.00273 * z * z + 0.00074 * z - 0.00058, min=1e-4)


def _whitening(cam: Camera, X):
    """Per-point whitening A (..., 3, 3) with A^T A = cov^-1 (fx for both
    axes, like the reference)."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    z = torch.clamp(z, min=1e-6)
    f = cam.fx
    sz = depth_std(z)
    zero = torch.zeros_like(z)
    return torch.stack(
        [
            torch.stack([f / z, zero, -f * x / (z * z)], dim=-1),
            torch.stack([zero, f / z, -f * y / (z * z)], dim=-1),
            torch.stack([zero, zero, 1.0 / sz], dim=-1),
        ],
        dim=-2,
    )


def _mah_dist_point_line(Xw, Aw, Bw):
    """Whitened point-to-line distance |(X-A) x (X-B)| / |B-A|
    (mah_dist3d_pt_line, LineExtractor.cpp:187-214)."""
    u, v = torch.broadcast_tensors(Xw - Aw, Xw - Bw)
    num = torch.linalg.vector_norm(torch.linalg.cross(u, v, dim=-1), dim=-1)
    den = torch.clamp(torch.linalg.vector_norm(Bw - Aw, dim=-1), min=1e-9)
    return num / den


def _support_spread_ok(t_proj, valid, n_cells: int = 10, ratio: float = 0.7):
    """verify3dLine: split the inliers' extent on the line into 10 cells and
    require >= 70% occupied. t_proj, valid: (..., S)."""
    BIG = 1e9
    t_lo = torch.min(torch.where(valid, t_proj, torch.full_like(t_proj, BIG)),
                     dim=-1, keepdim=True).values
    t_hi = torch.max(torch.where(valid, t_proj, torch.full_like(t_proj, -BIG)),
                     dim=-1, keepdim=True).values
    span = torch.clamp(t_hi - t_lo, min=1e-9)
    lam = torch.clamp((t_proj - t_lo) / span, 0.0, 1.0 - 1e-6)
    cell = torch.floor(lam * n_cells).to(torch.int64)
    # Invalid samples land in a spare cell that is dropped.
    cell = torch.where(valid, cell, n_cells)
    occupied = torch.zeros(t_proj.shape[:-1] + (n_cells + 1,), dtype=torch.bool,
                           device=t_proj.device)
    occupied.scatter_(-1, cell, True)
    frac = torch.mean(occupied[..., :n_cells].to(torch.float32), dim=-1)
    return frac > ratio


def _trial_pairs():
    """(N_TRIALS, 2) static sample-index pairs, spread across the segment
    (the JAX package's table: same seed, same draws)."""
    rng = np.random.default_rng(7)
    pairs = [(0, N_SAMPLES - 1), (2, N_SAMPLES - 3), (4, N_SAMPLES - 5),
             (1, N_SAMPLES // 2), (N_SAMPLES // 2, N_SAMPLES - 2)]
    while len(pairs) < N_TRIALS:
        a, b = rng.choice(N_SAMPLES, 2, replace=False)
        if abs(a - b) >= N_SAMPLES // 4:
            pairs.append((int(min(a, b)), int(max(a, b))))
    return np.asarray(pairs[:N_TRIALS], np.int64)


_PAIRS = _trial_pairs()


def _principal_dir(X, w, iters: int = 8):
    """Weighted principal direction of points (..., S, 3), weights (..., S):
    power iteration on the 3x3 scatter matrix."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mean = torch.sum(X * w[..., None], dim=-2) / wsum
    d = (X - mean[..., None, :]) * torch.sqrt(w)[..., None]
    C = torch.einsum("...si,...sj->...ij", d, d)
    v = torch.tensor([0.6, 0.5, 0.63], dtype=X.dtype, device=X.device).expand(
        X.shape[:-2] + (3,))
    for _ in range(iters):
        v = torch.einsum("...ij,...j->...i", C, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    return mean, v


def fit_lines_3d(cam: Camera, depth_img, sp, ep, line_valid):
    """Fit a 3D segment to each 2D segment from depth.

    depth_img: (H, W) float32 meters (0/neg = hole); sp/ep: (NL, 2);
    line_valid: (NL,) bool. Returns (p3_s (NL, 3), p3_e (NL, 3), dir3d
    (NL, 3), ok (NL,)) in the camera frame."""
    h, w = depth_img.shape
    dev = depth_img.device
    lam = torch.linspace(0.0, 1.0, N_SAMPLES, device=dev)[None, :, None]
    pts = sp[:, None, :] * (1.0 - lam) + ep[:, None, :] * lam  # (NL, S, 2)
    xi = torch.clamp(torch.round(pts[..., 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(pts[..., 1]).to(torch.int64), 0, h - 1)
    z = depth_img[yi, xi]  # (NL, S)
    valid = (z > 0.01) & line_valid[:, None]

    x = (xi.to(torch.float32) - cam.cx) * z / cam.fx
    y = (yi.to(torch.float32) - cam.cy) * z / cam.fy
    X = torch.stack([x, y, torch.where(valid, z, torch.ones_like(z))], dim=-1)
    A = _whitening(cam, X)  # (NL, S, 3, 3)
    Xw = torch.einsum("nsij,nsj->nsi", A, X)

    # --- fixed-trial RANSAC -------------------------------------------
    ia = torch.from_numpy(_PAIRS[:, 0]).to(dev)
    ib = torch.from_numpy(_PAIRS[:, 1]).to(dev)
    Pa = X[:, ia]  # (NL, T, 3)
    Pb = X[:, ib]
    pair_ok = valid[:, ia] & valid[:, ib] & (
        torch.linalg.vector_norm(Pb - Pa, dim=-1) > 1e-8
    )

    Aw_a = torch.einsum("nsij,ntj->nsti", A, Pa)  # (NL, S, T, 3)
    Aw_b = torch.einsum("nsij,ntj->nsti", A, Pb)
    dist = _mah_dist_point_line(Xw[:, :, None, :], Aw_a, Aw_b)  # (NL, S, T)
    inl = (dist < MAH_THRESH) & valid[:, :, None] & pair_ok[:, None, :]

    dir_t = Pb - Pa
    t_proj = torch.einsum("nsi,nti->nst", X, dir_t)
    spread_ok = _support_spread_ok(t_proj.transpose(1, 2), inl.transpose(1, 2))

    n_inl = torch.sum(inl, dim=1) * spread_ok * pair_ok  # (NL, T)
    best_t = torch.argmax(n_inl, dim=-1)  # first index on ties, as jnp
    best_n = torch.gather(n_inl, 1, best_t[:, None])[:, 0]
    best_inl = torch.gather(
        inl, 2, best_t[:, None, None].expand(-1, inl.shape[1], 1)
    )[:, :, 0]  # (NL, S)

    # --- PCA refit over the winning inlier set + one re-selection -------
    mean, vdir = _principal_dir(X, best_inl.to(torch.float32))
    Am = torch.einsum("nsij,nj->nsi", A, mean)
    Ad = torch.einsum("nsij,nj->nsi", A, mean + vdir)
    dist2 = _mah_dist_point_line(Xw, Am, Ad)
    inl2 = (dist2 < MAH_THRESH) & valid
    grew = torch.sum(inl2, dim=-1) > best_n
    final_inl = torch.where(grew[:, None], inl2, best_inl)
    mean, vdir = _principal_dir(X, final_inl.to(torch.float32))

    # --- endpoints: extremal projections of inliers ---------------------
    t_all = torch.einsum("nsi,ni->ns", X - mean[:, None, :], vdir)
    BIG = 1e9
    t_lo = torch.min(torch.where(final_inl, t_all, torch.full_like(t_all, BIG)), dim=-1).values
    t_hi = torch.max(torch.where(final_inl, t_all, torch.full_like(t_all, -BIG)), dim=-1).values
    p3_s = mean + t_lo[:, None] * vdir
    p3_e = mean + t_hi[:, None] * vdir

    n_valid = torch.sum(valid, dim=-1)
    n_final = torch.sum(final_inl, dim=-1)
    seg = p3_e - p3_s
    seg_len = torch.linalg.vector_norm(seg, dim=-1)
    ok = line_valid & (n_valid >= MIN_PTS) & (n_final >= 2) & (seg_len > MIN_LEN_3D)
    dir3d = seg / torch.clamp(seg_len, min=1e-9)[:, None]
    okc = ok[:, None]
    zero = torch.zeros_like(p3_s)
    return (
        torch.where(okc, p3_s, zero),
        torch.where(okc, p3_e, zero),
        torch.where(okc, dir3d, zero),
        ok,
    )
