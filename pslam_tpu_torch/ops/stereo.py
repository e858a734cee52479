"""Stereo matching: row-banded descriptor search + sub-pixel SAD refine (port
of ``pslam_tpu/ops/stereo.py``).

Replaces Frame::ComputeStereoMatches (reference src/Frame.cc:1165-1340):

1. one masked (NL, NR) Hamming matrix between left/right keypoints with a
   row band |vL - vR| <= 2 sigma(octave), the disparity bounds
   [minD, maxD] = [0, fx] (Frame.cc:1174-1186) and the octave window;
2. one batched sub-pixel refinement: an 11x11 left patch against an
   11x(11+2L) right strip over the 2L+1 shifts (Frame.cc:1233-1272), and the
   best shift's parabola fit (Frame.cc:1278-1284);
3. depth = bf / disparity for accepted matches (Frame.cc:1300-1305), behind a
   fixed 2.1x median-of-best-SADs gate.

The JAX package's one-hot column gather of the patches becomes plain
indexing (both exact). Its top-left corners are clipped to the image, as
there, which changes the patch at the border. The SAD sums add 121 values in
an order each framework picks, so they can differ from JAX's in the last
bits.
"""

from __future__ import annotations

import torch

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.ops.match import BIG, TH_HIGH, hamming_matrix

SAD_W = 5  # half window (11x11 patch, Frame.cc:1233 w=5)
SAD_L = 5  # slide range (Frame.cc:1255)


def _gather_patches(img, y0, x0, h: int, w: int):
    """(N, h, w) patches of ``img`` at integer top-left corners, each corner
    clipped to [0, H-h] x [0, W-w]."""
    H, W = img.shape
    y0 = torch.clamp(y0, 0, H - h)
    x0 = torch.clamp(x0, 0, W - w)
    rows = y0[:, None, None] + torch.arange(h, device=img.device)[None, :, None]
    cols = x0[:, None, None] + torch.arange(w, device=img.device)[None, None, :]
    return img[rows, cols]


def compute_stereo_matches(
    cam: Camera,
    imgL,
    imgR,
    uvL, levelL, descL, validL,
    uvR, levelR, descR, validR,
    scale: float = 1.2,
    levels: int = 8,
):
    """Per-left-keypoint virtual right coordinate + depth.

    Returns (ur (N,), depth (N,)) with ur = -1 / depth = 0 where no stereo
    match was accepted: the FrameData convention of the RGB-D path."""
    dev = uvL.device
    sfac = torch.tensor([scale**l for l in range(levels)], dtype=torch.float32, device=dev)
    levelL = levelL.to(torch.int64)
    levelR = levelR.to(torch.int64)
    sigL = sfac[torch.clamp(levelL, 0, levels - 1)]

    # --- 1. coarse match: Hamming + row band + disparity bounds ----------
    dist = hamming_matrix(descL, descR)
    dv = torch.abs(uvL[:, None, 1] - uvR[None, :, 1])
    band = dv <= 2.0 * sigL[:, None]  # Frame.cc:1198: r = 2 f * sigma
    disp = uvL[:, None, 0] - uvR[None, :, 0]
    min_d, max_d = 0.0, cam.fx  # maxD = bf/b = fx (Frame.cc:1184)
    dbound = (disp > min_d) & (disp <= max_d)
    # Candidate octave within [octave-1, octave+1] (Frame.cc:1216).
    lvl_ok = torch.abs(levelL[:, None] - levelR[None, :]) <= 1
    ok = band & dbound & lvl_ok & validL[:, None] & validR[None, :]
    d = torch.where(ok, dist, BIG)
    best, jR = torch.min(d, dim=1)
    coarse = best <= TH_HIGH  # thOrbDist analogue (Frame.cc:1224)

    # --- 2. sub-pixel SAD refine around the matched right column ---------
    w, L = SAD_W, SAD_L
    yL = torch.round(uvL[:, 1]).to(torch.int64)
    xL = torch.round(uvL[:, 0]).to(torch.int64)
    xR = torch.round(uvR[jR, 0]).to(torch.int64)
    patchL = _gather_patches(imgL, yL - w, xL - w, 2 * w + 1, 2 * w + 1)
    strip = _gather_patches(imgR, yL - w, xR - w - L, 2 * w + 1, 2 * w + 1 + 2 * L)
    # Center-pixel normalization (Frame.cc:1238-1249): the left patch minus
    # its centre, every candidate right window minus its own centre.
    patchL = patchL - patchL[:, w, w][:, None, None]
    idx = (torch.arange(2 * w + 1, device=dev)[None, :]
           + torch.arange(2 * L + 1, device=dev)[:, None])
    wins = strip[:, :, idx]  # (N, 11, 2L+1, 11)
    wins = wins - wins[:, w, :, w][:, None, :, None]
    sads = torch.sum(torch.abs(wins - patchL[:, :, None, :]), dim=(1, 3))  # (N, 2L+1)
    sad_min, s_best = torch.min(sads, dim=1)
    interior = (s_best > 0) & (s_best < 2 * L)  # Frame.cc:1275
    rows = torch.arange(sads.shape[0], device=dev)
    sm1 = sads[rows, torch.clamp(s_best - 1, min=0)]
    sp1 = sads[rows, torch.clamp(s_best + 1, max=2 * L)]
    denom = torch.clamp(2.0 * (sm1 + sp1 - 2.0 * sad_min), min=1e-6)
    delta = torch.clamp((sm1 - sp1) / denom, -1.0, 1.0)  # parabola vertex (Frame.cc:1282)
    uR = xR.to(torch.float32) + (s_best.to(torch.float32) - L) + delta

    # Disparity between patch centres (the SAD ran around the rounded left
    # x); the reported ur keeps the uvL frame: ur = uvL_x - disparity.
    disp_f = xL.to(torch.float32) - uR
    uR = uvL[:, 0] - disp_f
    good = (coarse & interior & (torch.abs(delta) <= 1.0)
            & (disp_f > min_d) & (disp_f <= max_d))
    # Median-SAD outlier sweep (Frame.cc:1308-1330).
    sad_sorted = torch.sort(torch.where(good, sad_min, torch.full_like(sad_min, float("inf"))),
                            stable=True).values
    n_good = torch.sum(good.to(torch.int64))
    med = torch.gather(sad_sorted, 0, torch.div(n_good, 2, rounding_mode="floor").view(1))[0]
    good = good & (sad_min <= 2.1 * med + 1e-3)

    disp_safe = torch.clamp(disp_f, min=1e-6)
    depth = torch.where(good, cam.bf / disp_safe, torch.zeros_like(disp_f))
    ur = torch.where(good, uR, torch.full_like(uR, -1.0))
    return ur, depth
