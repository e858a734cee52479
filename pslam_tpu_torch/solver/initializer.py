"""Monocular two-view initializer: parallel H/F RANSAC + motion recovery (port
of ``pslam_tpu/solver/initializer.py``).

Re-implements src/Initializer.cc: fit a homography and a fundamental matrix
with a fixed budget of 200 hypotheses each (Initializer.cc:37), score both
with the symmetric-transfer chi-square scores (CheckHomography :796,
CheckFundamental :850), refit each winner on all its inliers, pick the model
by RH = SH / (SH + SF) > 0.40 (:112-121), and recover (R, t) and the
triangulated structure from every candidate motion at once: the 4 of E
(DecomposeE :909) and the 8 of the Faugeras decomposition of H
(ReconstructH :572), voted by cheirality, reprojection and parallax (CheckRT
:772).

As solver/pnp.py does for the relocalization RANSAC, the hypotheses come in
two steps: ``two_view_draws`` draws uniforms from a CPU ``torch.Generator``
and turns them into (200, 4) homography and (200, 8) fundamental sample
indices, uniform among the valid matches; ``initialize_two_view`` solves from
those indices. The null vectors of the SVDs and ``eigh`` are defined up to
sign, and the candidate motions come in an order that follows those signs,
so two implementations agree on the chosen motion, not on its index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pslam_tpu_torch.solver.pnp import pnp_sample_indices

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # Gamma in CheckFundamental (Initializer.cc:861)
N_TRIALS = 200  # mMaxIterations (Initializer.cc:37)


class InitResult(NamedTuple):
    ok: torch.Tensor  # () bool
    used_H: torch.Tensor  # () bool
    R21: torch.Tensor  # (3, 3)
    t21: torch.Tensor  # (3,) unit norm
    X1: torch.Tensor  # (N, 3) points in frame-1 camera coords
    triangulated: torch.Tensor  # (N,) bool
    n_good: torch.Tensor  # () int


def two_view_draws(seed: int, valid):
    """(N_TRIALS, 4) homography and (N_TRIALS, 8) fundamental sample indices,
    uniform (with replacement) among the ``valid`` entries, from uniforms
    drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    u_h = torch.rand((N_TRIALS, 4), generator=g).to(valid.device)
    u_f = torch.rand((N_TRIALS, 8), generator=g).to(valid.device)
    return pnp_sample_indices(u_h, valid), pnp_sample_indices(u_f, valid)


def _normalize(uv, valid):
    """Hartley normalization (Normalize, Initializer.cc:749): zero mean, unit
    mean absolute deviation. Returns (uv_n, T (3, 3))."""
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(uv * w[:, None], dim=0) / n
    md = torch.sum(torch.abs(uv - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(md, min=1e-9)
    uv_n = (uv - mean) * s
    T = torch.zeros((3, 3), dtype=torch.float32, device=uv.device)
    T[0, 0], T[1, 1], T[2, 2] = s[0], s[1], 1.0
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return uv_n, T


def _null_vector_svd(A):
    """(..., m, 9) -> (..., 9): the right singular vector of the smallest
    singular value."""
    return torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :]


def _h_rows(x, y, u, v):
    """The two DLT rows of each correspondence, (..., 2, 9)."""
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    return r1, r2


def _f_rows(x, y, u, v):
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], dim=-1)


def _rank2(F):
    U, S, Vh = torch.linalg.svd(F)
    S = S.clone()
    S[..., 2] = 0.0
    return (U * S[..., None, :]) @ Vh


def _dlt_h(p1, p2):
    """Batched 4-point homography DLT: (T, 4, 2) x2 -> (T, 3, 3), p2 ~ H p1."""
    r1, r2 = _h_rows(p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1])  # (T, 4, 9)
    A = torch.stack([r1, r2], dim=2).reshape(p1.shape[0], 8, 9)
    return _null_vector_svd(A).reshape(-1, 3, 3)


def _eight_point_f(p1, p2):
    """Batched 8-point fundamental: (T, 8, 2) x2 -> rank-2 F, x2^T F x1 = 0."""
    A = _f_rows(p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1])  # (T, 8, 9)
    return _rank2(_null_vector_svd(A).reshape(-1, 3, 3))


def _homog(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def _h_transfer_chi2(H, uv1, uv2, inv_sigma2):
    """Symmetric transfer chi2 of (T, 3, 3) homographies, both directions,
    (T, N) each."""
    def err(H, a, b):
        p = torch.einsum("nj,tij->tni", _homog(a), H)
        z = p[..., 2:]
        p = p[..., :2] / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
        return torch.sum((p - b) ** 2, dim=-1) * inv_sigma2

    return err(H, uv1, uv2), err(torch.linalg.inv(H), uv2, uv1)


def _f_line_chi2(F, uv1, uv2, inv_sigma2):
    """Point-to-epipolar-line chi2 in both images, (T, N) each."""
    x1, x2 = _homog(uv1), _homog(uv2)
    l2 = torch.einsum("nj,tij->tni", x1, F)  # lines in image 2
    l1 = torch.einsum("ni,tij->tnj", x2, F)  # lines in image 1
    d2 = torch.sum(l2 * x2, dim=-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * x1, dim=-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d1 * inv_sigma2, d2 * inv_sigma2


def _wls_null_vector(A, w):
    """Null vector of the weighted normal matrix sum_n w_n A_n A_n^T."""
    M = torch.einsum("ni,nj,n->ij", A, A, w)
    return torch.linalg.eigh(M)[1][:, 0]


def _fix_det(R):
    return R * torch.sign(torch.linalg.det(R))


def _e_candidates(F, K):
    """The four (R, t) of E = K^T F K (DecomposeE, Initializer.cc:909)."""
    E = K.T @ F @ K
    U, _, Vh = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=F.device)
    t = U[:, 2] / torch.clamp(torch.linalg.vector_norm(U[:, 2]), min=1e-9)
    R1 = _fix_det(U @ W @ Vh)
    R2 = _fix_det(U @ W.T @ Vh)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _h_candidates(H, K):
    """The eight (R, t) of the Faugeras decomposition of A = K^-1 H K
    (ReconstructH, Initializer.cc:572-673)."""
    dev = H.device
    A = torch.linalg.inv(K) @ H @ K
    Ua, d, Vh = torch.linalg.svd(A)
    s_det = torch.linalg.det(Ua) * torch.linalg.det(Vh.T)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    aux_st = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    aux_st2 = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    cph = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    Rs, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            # d' = d2 (Initializer.cc:611-641)
            st = e1 * e3 * aux_st
            Rp = torch.stack([torch.stack([ct, zero, -st]), torch.stack([zero, one, zero]),
                              torch.stack([st, zero, ct])])
            tp = torch.stack([e1 * aux1, zero, -e3 * aux3]) * (d1 - d3)
            Rs.append(s_det * (Ua @ Rp @ Vh))
            ts.append(Ua @ tp)
            # d' = -d2 (:643-673)
            sph = e1 * e3 * aux_st2
            Rn = torch.stack([torch.stack([cph, zero, sph]), torch.stack([zero, -one, zero]),
                              torch.stack([sph, zero, -cph])])
            tn = torch.stack([e1 * aux1, zero, e3 * aux3]) * (d1 + d3)
            Rs.append(s_det * (Ua @ Rn @ Vh))
            ts.append(Ua @ tn)
    return torch.stack(Rs), torch.stack(ts)


def _check_rt(Rs, ts, uv1, uv2, inliers, fx, fy, cx, cy, inv_s2):
    """CheckRT (Initializer.cc:772) for C candidates at once: triangulate
    every pair, count cheirality + reprojection survivors, take the parallax
    at the 50th-best point. Returns (n_good (C,), parallax_deg (C,),
    X1 (C, N, 3), good (C, N))."""
    C, N = Rs.shape[0], uv1.shape[0]
    tn = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-9)
    x1 = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], dim=1)
    x2 = torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], dim=1)
    P2 = torch.cat([Rs, tn[:, :, None]], dim=2)  # (C, 3, 4)
    # DLT rows for P1 = [I|0], P2 = [R|t], one (4, 4) system per pair.
    zero = torch.zeros_like(x1[:, 0])
    one = torch.ones_like(zero)
    r0 = torch.stack([one, zero, -x1[:, 0], zero], dim=-1).expand(C, N, 4)
    r1 = torch.stack([zero, one, -x1[:, 1], zero], dim=-1).expand(C, N, 4)
    r2 = P2[:, None, 0, :] - x2[None, :, 0, None] * P2[:, None, 2, :]
    r3 = P2[:, None, 1, :] - x2[None, :, 1, None] * P2[:, None, 2, :]
    A = torch.stack([r0, r1, r2, r3], dim=2)  # (C, N, 4, 4)
    X = torch.linalg.svd(A).Vh[..., -1, :]
    w = X[..., 3:]
    X1 = X[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    z1 = X1[..., 2]
    X2 = torch.einsum("cnj,cij->cni", X1, Rs) + tn[:, None, :]
    z2 = X2[..., 2]
    # Parallax between the two viewing rays.
    C2 = -torch.einsum("cji,cj->ci", Rs, tn)  # camera-2 centre in frame 1
    n2 = X1 - C2[:, None, :]
    cosp = torch.sum(X1 * n2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(X1, dim=-1) * torch.linalg.vector_norm(n2, dim=-1), min=1e-9)
    # Reprojection gates (4 sigma^2, Initializer.cc:831).
    z1s, z2s = torch.clamp(z1, min=1e-9), torch.clamp(z2, min=1e-9)
    e1 = (fx * X1[..., 0] / z1s + cx - uv1[:, 0]) ** 2 + (fy * X1[..., 1] / z1s + cy - uv1[:, 1]) ** 2
    e2 = (fx * X2[..., 0] / z2s + cx - uv2[:, 0]) ** 2 + (fy * X2[..., 1] / z2s + cy - uv2[:, 1]) ** 2
    good = (inliers[None, :] & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < 4.0 / inv_s2) & (e2 < 4.0 / inv_s2))
    # Parallax at the 50th-best point.
    n_good = torch.sum(good.to(torch.int64), dim=1)
    cos_sorted = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)), dim=1).values
    idx50 = torch.clamp(torch.clamp(n_good - 1, min=0), max=49)
    cos50 = torch.gather(cos_sorted, 1, idx50[:, None])[:, 0]
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cos50, -1.0, 1.0)))
    return n_good, parallax, X1, good


def initialize_two_view(
    uv1, uv2, valid, h_idx, f_idx,
    fx: float, fy: float, cx: float, cy: float,
    sigma: float = 1.0,
    min_parallax_deg: float = 1.0,
    min_triangulated: int = 50,
) -> InitResult:
    """Mono initialization from matched pixel coordinates (Initializer::
    Initialize, Initializer.cc:44-122).

    uv1 / uv2 (N, 2) matched keypoints of frame 1 / frame 2, valid (N,) bool,
    h_idx (N_TRIALS, 4) and f_idx (N_TRIALS, 8) the RANSAC samples. Returns
    the camera-2-from-camera-1 motion (R21, t21) and the structure in frame
    1."""
    dev = uv1.device
    inv_s2 = 1.0 / sigma**2
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32,
                     device=dev)

    # --- RANSAC both models on normalized coordinates ---------------------
    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    T2inv = torch.linalg.inv(T2)
    Hs = T2inv @ _dlt_h(uv1n[h_idx], uv2n[h_idx]) @ T1
    Fs = T2.T @ _eight_point_f(uv1n[f_idx], uv2n[f_idx]) @ T1
    w = valid.to(torch.float32)

    def score_h(H):
        c1, c2 = _h_transfer_chi2(H, uv1, uv2, inv_s2)
        zero = torch.zeros_like(c1)
        s = (torch.where(c1 < CHI2_H, CHI2_H - c1, zero)
             + torch.where(c2 < CHI2_H, CHI2_H - c2, zero))
        return torch.sum(s * w, dim=-1), (c1 < CHI2_H) & (c2 < CHI2_H) & valid

    def score_f(F):
        c1, c2 = _f_line_chi2(F, uv1, uv2, inv_s2)
        zero = torch.zeros_like(c1)
        s = (torch.where(c1 < CHI2_F, SCORE_TH - c1, zero)
             + torch.where(c2 < CHI2_F, SCORE_TH - c2, zero))
        return torch.sum(s * w, dim=-1), (c1 < CHI2_F) & (c2 < CHI2_F) & valid

    sH, inH = score_h(Hs)
    sF, inF = score_f(Fs)
    bh, bf = torch.argmax(sH), torch.argmax(sF)
    SH, SF = sH[bh], sF[bf]

    # Refit each winning model on all of its inliers (weighted normalized
    # DLT): a noisy minimal sample leaves the translation direction several
    # degrees off.
    x, y, u, v = uv1n[:, 0], uv1n[:, 1], uv2n[:, 0], uv2n[:, 1]
    wh = inH[bh].to(torch.float32)
    r1, r2 = _h_rows(x, y, u, v)
    h = _wls_null_vector(torch.cat([r1, r2], dim=0), torch.cat([wh, wh]))
    H_best = T2inv @ h.reshape(3, 3) @ T1
    f = _wls_null_vector(_f_rows(x, y, u, v), inF[bf].to(torch.float32))
    F_best = T2.T @ _rank2(f.reshape(3, 3)) @ T1
    _, H_in = score_h(H_best[None])
    _, F_in = score_f(F_best[None])

    use_H = SH / torch.clamp(SH + SF, min=1e-9) > 0.40  # Initializer.cc:115
    inliers = torch.where(use_H, H_in[0], F_in[0])
    n_inl = torch.sum(inliers.to(torch.int64))

    def pick(Rs, ts):
        ns, pars, Xs, goods = _check_rt(Rs, ts, uv1, uv2, inliers, fx, fy, cx, cy, inv_s2)
        best = torch.argmax(ns)
        n_best = ns[best]
        # Accept: a clear winner, enough parallax, enough points, and > 90%
        # of the inlier count (Initializer.cc:550-566, 721).
        second = torch.sort(ns).values[-2]
        ok = ((second < 0.75 * n_best) & (pars[best] > min_parallax_deg)
              & (n_best > min_triangulated) & (n_best > 0.9 * n_inl))
        return ok, Rs[best], ts[best], Xs[best], goods[best], n_best

    okF, RF, tF, XF, gF, nF = pick(*_e_candidates(F_best, K))
    okH, RH, tH, XH, gH, nH = pick(*_h_candidates(H_best, K))
    t = torch.where(use_H, tH, tF)
    return InitResult(
        ok=torch.where(use_H, okH, okF),
        used_H=use_H,
        R21=torch.where(use_H, RH, RF),
        t21=t / torch.clamp(torch.linalg.vector_norm(t), min=1e-9),
        X1=torch.where(use_H, XH, XF),
        triangulated=torch.where(use_H, gH, gF),
        n_good=torch.where(use_H, nH, nF),
    )
