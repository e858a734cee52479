"""Line-segment detection as a batched tile/structure-tensor program (port
of ``pslam_tpu/ops/lines.py``).

Replaces the reference's LSD detector + EDLines (Thirdparty/line_descriptor,
add_src/LineExtractor.cpp:325-366) and the collinear-merge post-pass
(add_src/uselongline.cpp:24-336) the way the JAX package does: fixed tiles
each propose at most one segment from their gradient structure tensor, a
fixed number of masked pairwise merge passes glue tile fragments into full
segments, and the longest ``n_lines`` survive.

Top-k is a stable descending sort (``orb.topk_stable``): the phase-0 and
phase-1 tilings propose exact duplicates, and ``lax.top_k`` keeps the lower
index first among equal lengths.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from pslam_tpu_torch.ops.orb import topk_stable


@dataclasses.dataclass(frozen=True)
class LineConfig:
    n_lines: int = 128  # capacity (reference nFeatures=200, TUM1.yaml:56)
    tile: int = 16
    mag_thr: float = 12.0  # gradient magnitude threshold (LSD rho ~ 2/sin(tol))
    align_tol: float = 0.3927  # orientation tolerance, 22.5 deg (LSD default)
    min_support_frac: float = 0.045  # of tile pixels
    max_perp_spread: float = 1.2  # px RMS across-line spread (straightness)
    min_len: float = 18.0  # final min segment length
    merge_passes: int = 4
    merge_angle: float = 0.06  # rad (~3.5 deg), uselongline angle gate
    merge_perp: float = 2.0  # px midpoint-to-line offset
    merge_gap: float = 24.0  # px endpoint gap along the direction


class LineFeatures(NamedTuple):
    """SoA line-segment set (fixed capacity NL)."""

    sp: torch.Tensor  # (NL, 2) start point (x, y)
    ep: torch.Tensor  # (NL, 2) end point (x, y)
    angle: torch.Tensor  # (NL,) canonical direction angle in (-pi, pi]
    length: torch.Tensor  # (NL,)
    eq2d: torch.Tensor  # (NL, 3) normalized image-line equation (Frame.cc:520-528)
    response: torch.Tensor  # (NL,) mean supporting gradient magnitude
    valid: torch.Tensor  # (NL,) bool


def image_gradients(img):
    """Central-difference gradients (gx, gy) of an (H, W) image, zero on a
    2 px border (kills the roll wrap-around and image-boundary edges)."""
    gx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    gy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    h, w = img.shape[-2:]
    ys = torch.arange(h, device=img.device)
    xs = torch.arange(w, device=img.device)
    interior = (
        ((ys >= 2) & (ys < h - 2))[:, None] & ((xs >= 2) & (xs < w - 2))[None, :]
    ).to(img.dtype)
    return gx * interior, gy * interior


def _tile_candidates(img, cfg: LineConfig, offset: int = 0):
    """Per-tile segment proposals over the tiling shifted by ``offset`` px in
    both axes. Returns (sp, ep, resp, ok) over T = (H'//t)*(W'//t) tiles."""
    gx, gy = image_gradients(img)
    if offset:
        gx = gx[offset:, offset:]
        gy = gy[offset:, offset:]
    h, w = gx.shape
    t = cfg.tile
    ny, nx = h // t, w // t
    dev = img.device

    def tiles(a):
        return (
            a[: ny * t, : nx * t]
            .reshape(ny, t, nx, t)
            .permute(0, 2, 1, 3)
            .reshape(ny * nx, t * t)
        )

    gxx, gyy, gxy = tiles(gx * gx), tiles(gy * gy), tiles(gx * gy)
    mag2 = gxx + gyy
    strong = mag2 > cfg.mag_thr**2  # (T, t*t)
    zero = torch.zeros((), dtype=img.dtype, device=dev)

    wgt = torch.where(strong, mag2, zero)
    sxx = torch.sum(torch.where(strong, gxx, zero), dim=1)
    syy = torch.sum(torch.where(strong, gyy, zero), dim=1)
    sxy = torch.sum(torch.where(strong, gxy, zero), dim=1)

    # Principal gradient direction; the LINE direction is perpendicular.
    theta_g = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    line_dir = torch.stack([-torch.sin(theta_g), torch.cos(theta_g)], dim=-1)

    tr = sxx + syy
    root = torch.sqrt((sxx - syy) ** 2 + 4.0 * sxy * sxy + 1e-12)
    lam1 = 0.5 * (tr + root)
    aniso = lam1 / torch.clamp(tr, min=1e-9)  # in [0.5, 1]

    # Support: strong pixels aligned with the dominant gradient direction.
    ca, sa = torch.cos(theta_g)[:, None], torch.sin(theta_g)[:, None]
    gxt, gyt = tiles(gx), tiles(gy)
    along = gxt * ca + gyt * sa
    cross = -gxt * sa + gyt * ca
    align = torch.abs(torch.atan2(cross, torch.abs(along))) < cfg.align_tol
    support = strong & align
    n_sup = torch.sum(support, dim=1)
    wsup = torch.where(support, wgt, zero)
    wsum = torch.clamp(torch.sum(wsup, dim=1), min=1e-9)

    yy, xx = np.mgrid[0:t, 0:t]
    px_local = torch.from_numpy(
        np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1).astype(np.float32)
    ).to(dev)
    ty, tx = np.divmod(np.arange(ny * nx), nx)
    origin = torch.from_numpy(
        np.stack([tx * t + offset, ty * t + offset], axis=-1).astype(np.float32)
    ).to(dev)
    pix = origin[:, None, :] + px_local[None, :, :]  # (T, t*t, 2)

    cen = torch.sum(wsup[..., None] * pix, dim=1) / wsum[:, None]
    d = pix - cen[:, None, :]
    t_along = torch.sum(d * line_dir[:, None, :], dim=-1)
    t_cross = d[..., 0] * line_dir[:, None, 1] - d[..., 1] * line_dir[:, None, 0]

    BIG = 1e9
    t_min = torch.min(torch.where(support, t_along, zero + BIG), dim=1).values
    t_max = torch.max(torch.where(support, t_along, zero - BIG), dim=1).values
    spread = torch.sqrt(torch.sum(wsup * t_cross * t_cross, dim=1) / wsum)

    ok = (
        (n_sup >= cfg.min_support_frac * t * t)
        & (aniso > 0.85)
        & (spread <= cfg.max_perp_spread)
        & (t_max - t_min >= 4.0)
    )
    sp = cen + t_min[:, None] * line_dir
    ep = cen + t_max[:, None] * line_dir
    resp = torch.sqrt(wsum / torch.clamp(n_sup, min=1))
    return sp, ep, resp, ok


def _merge_pass(sp, ep, resp, valid, cfg: LineConfig):
    """One absorb pass: every valid segment may absorb weaker mergeable
    segments that chose it as their best absorber (uselongline::MergeLines
    gates: angle, perpendicular offset, axial gap)."""
    n = sp.shape[0]
    dev = sp.device
    d = ep - sp
    length = torch.linalg.vector_norm(d, dim=-1)
    dirs = d / torch.clamp(length, min=1e-9)[:, None]
    mid = 0.5 * (sp + ep)

    # Angle gap mod pi (floor mod, as jnp's %).
    ang = torch.remainder(torch.atan2(d[:, 1], d[:, 0]), math.pi)
    dang = torch.abs(ang[:, None] - ang[None, :])
    dang = torch.minimum(dang, math.pi - dang)

    rel = mid[None, :, :] - mid[:, None, :]  # (i, j, 2)
    perp = torch.abs(rel[..., 0] * dirs[:, None, 1] - rel[..., 1] * dirs[:, None, 0])

    def proj(p):  # (j, 2) points onto axis of i -> (i, j)
        r = p[None, :, :] - mid[:, None, :]
        return torch.sum(r * dirs[:, None, :], dim=-1)

    i_lo, i_hi = -0.5 * length[:, None], 0.5 * length[:, None]
    j_a, j_b = proj(sp), proj(ep)
    j_lo, j_hi = torch.minimum(j_a, j_b), torch.maximum(j_a, j_b)
    gap = torch.maximum(j_lo - i_hi, i_lo - j_hi)  # negative = overlap

    ar = torch.arange(n, device=dev)
    mergeable = (
        (dang < cfg.merge_angle)
        & (perp < cfg.merge_perp)
        & (gap < cfg.merge_gap)
        & valid[:, None]
        & valid[None, :]
        & (ar[:, None] != ar[None, :])
    )
    # j may be absorbed by i only if i is strictly stronger (longer; index
    # breaks ties), so the absorber itself survives this pass.
    key = length + (1e-3 / n) * ar.to(length.dtype)
    stronger = key[:, None] > key[None, :]
    can_absorb = mergeable & stronger
    score = torch.where(can_absorb, key[:, None], torch.full_like(key[:, None], -1.0))
    absorber = torch.argmax(score, dim=0)  # (j,)
    absorbed = torch.max(score, dim=0).values > 0.0
    absorb_mat = (ar[:, None] == absorber[None, :]) & absorbed[None, :]

    BIG = 1e9
    lo_j = torch.where(absorb_mat, j_lo, torch.full_like(j_lo, BIG))
    hi_j = torch.where(absorb_mat, j_hi, torch.full_like(j_hi, -BIG))
    new_lo = torch.minimum(i_lo[:, 0], torch.min(lo_j, dim=1).values)
    new_hi = torch.maximum(i_hi[:, 0], torch.max(hi_j, dim=1).values)
    sp_new = mid + new_lo[:, None] * dirs
    ep_new = mid + new_hi[:, None] * dirs
    resp_new = torch.maximum(
        resp,
        torch.max(torch.where(absorb_mat, resp[None, :], torch.zeros_like(lo_j)), dim=1).values,
    )
    valid_new = valid & ~absorbed
    return sp_new, ep_new, resp_new, valid_new


def _pad_rows(a, n: int):
    if a.shape[0] >= n:
        return a
    pad = a.new_zeros((n - a.shape[0],) + a.shape[1:])
    return torch.cat([a, pad], dim=0)


def detect_lines(img, cfg: LineConfig = LineConfig()) -> LineFeatures:
    """img: (H, W) float32 grayscale in [0, 255] -> LineFeatures."""
    c0 = _tile_candidates(img, cfg, 0)
    c1 = _tile_candidates(img, cfg, cfg.tile // 2)
    sp, ep, resp, valid = (torch.cat([a, b], dim=0) for a, b in zip(c0, c1))

    # Pre-truncate to a fixed merge pool (most tiles propose nothing).
    pool = min(4 * cfg.n_lines, valid.shape[0])
    pre_len = torch.linalg.vector_norm(ep - sp, dim=-1)
    _, keep = topk_stable(torch.where(valid, pre_len, torch.full_like(pre_len, -1.0)), pool)
    sp, ep, resp, valid = sp[keep], ep[keep], resp[keep], valid[keep]

    for _ in range(cfg.merge_passes):
        sp, ep, resp, valid = _merge_pass(sp, ep, resp, valid, cfg)

    length = torch.linalg.vector_norm(ep - sp, dim=-1)
    valid = valid & (length >= cfg.min_len)

    # Top-K by length into the fixed capacity.
    score = torch.where(valid, length, torch.full_like(length, -1.0))
    k = min(cfg.n_lines, score.shape[0])
    top_v, top_i = topk_stable(score, k)
    sp, ep, resp = sp[top_i], ep[top_i], resp[top_i]
    length = torch.clamp(top_v, min=0.0)
    valid = top_v > 0.0
    sp, ep, resp, length, valid = (
        _pad_rows(a, cfg.n_lines) for a in (sp, ep, resp, length, valid)
    )

    # Canonical orientation: flip endpoints so the mean perpendicular
    # gradient along the line is positive (dark -> bright to the left).
    h, w = img.shape
    gx, gy = image_gradients(img)
    t_s = torch.linspace(0.1, 0.9, 8, device=img.device)
    samp = sp[:, None, :] + t_s[None, :, None] * (ep - sp)[:, None, :]
    sxi = torch.clamp(torch.round(samp[..., 0]).to(torch.int64), 0, w - 1)
    syi = torch.clamp(torch.round(samp[..., 1]).to(torch.int64), 0, h - 1)
    d0 = ep - sp
    nrm0 = torch.stack([-d0[:, 1], d0[:, 0]], dim=-1)
    g_per = (
        gx[syi, sxi] * nrm0[:, None, 0] + gy[syi, sxi] * nrm0[:, None, 1]
    ).sum(dim=1)
    flip = (g_per < 0.0)[:, None]
    sp, ep = torch.where(flip, ep, sp), torch.where(flip, sp, ep)

    d = ep - sp
    angle = torch.atan2(d[:, 1], d[:, 0])
    # Homogeneous image-line equation (sp,1) x (ep,1) / sqrt(a^2+b^2)
    # (LineExtractor.cpp:352-362).
    a = sp[:, 1] - ep[:, 1]
    b = ep[:, 0] - sp[:, 0]
    c = sp[:, 0] * ep[:, 1] - sp[:, 1] * ep[:, 0]
    nrm = torch.clamp(torch.sqrt(a * a + b * b), min=1e-9)
    eq2d = torch.stack([a / nrm, b / nrm, c / nrm], dim=-1)
    return LineFeatures(
        sp=sp, ep=ep, angle=angle, length=length, eq2d=eq2d,
        response=resp, valid=valid,
    )
