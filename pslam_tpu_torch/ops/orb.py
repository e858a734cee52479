"""Oriented-FAST + rotated-BRIEF extraction (port of ``pslam_tpu/ops/orb.py``).

Same algorithm as the JAX package: full-stack FAST at both thresholds with a
per-cell fallback, grid-bucketed per-cell top-k then per-level top-quota,
IC angle from patch moments, and a seeded Gaussian BRIEF pattern sampled at
32 quantized rotations. The BRIEF pattern and the per-bin sample tables are
built with numpy exactly as the JAX package builds them.

Two TPU devices become plain indexing with identical results: the one-hot
column-select matmul of ``extract_patches`` and the BRIEF selection matmul
(which, being one-hot in bf16, samples bf16-rounded pixels exactly).
Top-k uses a stable descending sort, so ties go to the lowest index first
like ``lax.top_k`` (``approx_max_k`` is exact off the TPU).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from pslam_tpu_torch.ops.fast import fast_score_dual, nms3x3
from pslam_tpu_torch.ops.image import build_pyramid, gaussian_blur

HALF_PATCH = 15  # reference HALF_PATCH_SIZE (ORBextractor.cc:73)
EDGE = 16  # reference minBorder = EDGE_THRESHOLD-3 (ORBextractor.cc:771-774)
PATCH = 32  # descriptor/moment patch side (see the JAX module)
N_ANGLE_BINS = 32


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1000
    levels: int = 8
    scale: float = 1.2
    th_fast_hi: int = 20  # iniThFAST (TUM1.yaml:58)
    th_fast_lo: int = 7  # minThFAST (TUM1.yaml:62)
    cell: int = 32  # spread-grid cell size on the canvas
    k_per_cell: int = 8

    @property
    def level_quota(self):
        """Per-level keypoint budget, geometric in 1/scale (mnFeaturesPerLevel,
        ORBextractor.cc:442-457)."""
        f = 1.0 / self.scale
        n_desired = self.n_features * (1 - f) / (1 - f**self.levels)
        quotas = [int(round(n_desired * f**l)) for l in range(self.levels)]
        quotas[-1] = max(self.n_features - sum(quotas[:-1]), 0)
        return quotas

    @property
    def capacity(self):
        return sum(self.level_quota)


class OrbFeatures(NamedTuple):
    """SoA keypoint set (fixed capacity N = config.capacity)."""

    uv: torch.Tensor  # (N, 2) level-0 pixel coords (x, y)
    uv_lvl: torch.Tensor  # (N, 2) level-local coords on the canvas
    level: torch.Tensor  # (N,) int32 octave
    response: torch.Tensor  # (N,) float32
    angle: torch.Tensor  # (N,) float32 radians
    desc: torch.Tensor  # (N, 32) uint8 packed 256-bit descriptor
    valid: torch.Tensor  # (N,) bool


def topk_stable(x, k: int):
    """Top-k along the last axis with ties to the lowest index first (the
    ``lax.top_k`` order). Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Patches and orientation


def extract_patches(stack, uv_lvl, level, size: int = PATCH):
    """(N, size, size) patches around keypoints (clamped to the canvas)."""
    L, h, w = stack.shape
    half = size // 2
    y0 = torch.clamp(uv_lvl[:, 1].to(torch.int64) - half, 0, h - size)
    x0 = torch.clamp(uv_lvl[:, 0].to(torch.int64) - half, 0, w - size)
    ar = torch.arange(size, device=stack.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return stack[level.to(torch.int64)[:, None, None], rows, cols]


@functools.lru_cache(maxsize=4)
def _moment_matrix(size: int, device):
    r = HALF_PATCH
    c = size // 2
    ys, xs = np.mgrid[0:size, 0:size]
    mask = ((xs - c) ** 2 + (ys - c) ** 2) <= r**2 + 1
    kx = ((xs - c) * mask).astype(np.float32).reshape(-1)
    ky = ((ys - c) * mask).astype(np.float32).reshape(-1)
    return torch.from_numpy(np.stack([kx, ky], axis=-1)).to(device)


def keypoint_angles(patches):
    """IC angle from (N, P, P) patches via the circular-patch moments."""
    n, size = patches.shape[0], patches.shape[-1]
    m = patches.reshape(n, -1) @ _moment_matrix(size, patches.device)
    return torch.atan2(m[:, 1], m[:, 0])


# ---------------------------------------------------------------------------
# Descriptor pattern


def _brief_pattern(n_bits: int = 256, seed: int = 1234):
    """(n_bits, 4) int32 [ax, ay, bx, by] Gaussian test pairs (BRIEF G-II),
    clipped to a disk of radius HALF_PATCH-2."""
    rng = np.random.default_rng(seed)
    sigma = (2 * HALF_PATCH + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 4))
    r_max = float(HALF_PATCH - 2)
    for cols in ((0, 1), (2, 3)):
        xy = pts[:, cols]
        r = np.linalg.norm(xy, axis=1, keepdims=True)
        pts[:, cols] = np.where(r > r_max, xy * (r_max / r), xy)
    return np.round(pts).astype(np.int32)


_PATTERN = _brief_pattern()


def bin_sample_indices():
    """(B, 512) int32: flattened patch index of each rotated test point for
    each quantized angle bin (256 a-points then 256 b-points)."""
    pat = np.asarray(_PATTERN, np.float64)
    pts = np.concatenate([pat[:, 0:2], pat[:, 2:4]], axis=0)  # (512, 2)
    half = PATCH // 2
    out = np.zeros((N_ANGLE_BINS, 512), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = pts[:, 0] * ca - pts[:, 1] * sa
        ry = pts[:, 0] * sa + pts[:, 1] * ca
        xi = np.clip(np.round(rx).astype(np.int64) + half, 0, PATCH - 1)
        yi = np.clip(np.round(ry).astype(np.int64) + half, 0, PATCH - 1)
        out[b] = (yi * PATCH + xi).astype(np.int32)
    return out


@functools.lru_cache(maxsize=4)
def _bin_sample_tensor(device):
    return torch.from_numpy(bin_sample_indices().astype(np.int64)).to(device)


def _brief_bits(bpatch, angle):
    """(N, P, P) blurred patches + (N,) angles -> (N, 256) uint8 bits.

    Each keypoint's angle picks one of 32 rotated patterns; the test compares
    bf16-rounded pixels (the TPU samples through a bf16 one-hot matmul)."""
    n = bpatch.shape[0]
    flat = bpatch.reshape(n, -1).to(torch.bfloat16).float()
    two_pi = 2.0 * np.pi
    bin_f = torch.remainder(angle, two_pi) * (N_ANGLE_BINS / two_pi)
    kp_bin = torch.remainder(torch.round(bin_f).to(torch.int64), N_ANGLE_BINS)
    idx = _bin_sample_tensor(bpatch.device)[kp_bin]  # (N, 512)
    s = torch.gather(flat, 1, idx)
    return (s[:, :256] < s[:, 256:]).to(torch.uint8)


# ---------------------------------------------------------------------------
# Extraction


@functools.lru_cache(maxsize=4)
def _per_level_mask(levels: int, scale: float, h: int, w: int, device):
    """Detection-valid mask per level: inside the level extent minus EDGE."""
    masks = []
    ys, xs = np.mgrid[0:h, 0:w]
    for l in range(levels):
        s = 1.0 / scale**l
        hl, wl = int(round(h * s)), int(round(w * s))
        masks.append((xs >= EDGE) & (xs < wl - EDGE) & (ys >= EDGE) & (ys < hl - EDGE))
    return torch.from_numpy(np.stack(masks)).to(device)


def detect_keypoints(stack, cfg: OrbConfig, h: int, w: int):
    """FAST + per-cell fallback + spread top-k selection on a level stack.

    Returns (uv_lvl (N, 2) canvas coords, level (N,), response (N,))
    (ComputeKeyPointsOctTree + DistributeOctTree semantics as masked
    reductions)."""
    L = cfg.levels
    dev = stack.device
    det_mask = _per_level_mask(L, cfg.scale, h, w, dev)

    hi_corner, lo_corner, score_lo = fast_score_dual(
        stack, cfg.th_fast_hi, cfg.th_fast_lo
    )
    zero = torch.zeros((), dtype=score_lo.dtype, device=dev)
    keep_nms = nms3x3(torch.where(lo_corner & det_mask, score_lo, zero))

    cs = cfg.cell
    ncy, ncx = h // cs, w // cs
    hc, wc = ncy * cs, ncx * cs

    def to_cells(x):
        """(L, H, W) -> (L, ncy, ncx, cs*cs)."""
        return (
            x[:, :hc, :wc]
            .reshape(L, ncy, cs, ncx, cs)
            .permute(0, 1, 3, 2, 4)
            .reshape(L, ncy, ncx, cs * cs)
        )

    # Threshold fallback in cell space (ORBextractor.cc:800-816).
    cand = to_cells(keep_nms & lo_corner & det_mask)
    hi_c = to_cells(hi_corner & det_mask) & cand
    has_hi = hi_c.any(dim=-1, keepdim=True)
    allowed = torch.where(has_hi, hi_c, cand)
    cell_scores = torch.where(allowed, to_cells(score_lo), zero)

    k = cfg.k_per_cell
    top_v, top_i = topk_stable(cell_scores, k)  # (L, ncy, ncx, k)
    iy = top_i // cs
    ix = top_i % cs
    cy = torch.arange(ncy, device=dev)[None, :, None, None]
    cx = torch.arange(ncx, device=dev)[None, None, :, None]
    ys = (cy * cs + iy).reshape(L, -1)
    xs = (cx * cs + ix).reshape(L, -1)
    vs = top_v.reshape(L, -1)

    uv_lvl, level_arr, resp = [], [], []
    for l, q in enumerate(cfg.level_quota):
        v_l, idx = topk_stable(vs[l], q)
        uv_lvl.append(torch.stack([xs[l][idx], ys[l][idx]], dim=-1))
        level_arr.append(torch.full((q,), l, dtype=torch.int32, device=dev))
        resp.append(v_l)
    uv_lvl = torch.cat(uv_lvl).to(torch.float32)
    level = torch.cat(level_arr)
    response = torch.cat(resp).to(torch.float32)
    return uv_lvl, level, response


def extract_orb(img, cfg: OrbConfig = OrbConfig()) -> OrbFeatures:
    """img: (H, W) float32 grayscale in [0, 255] -> OrbFeatures."""
    h, w = img.shape
    stack, level_scale = build_pyramid(img, cfg.levels, cfg.scale)
    # Detection runs on a bf16 stack (see fast_score_dual); the descriptor
    # half (blur, patches, BRIEF) stays f32.
    uv_lvl, level, response = detect_keypoints(
        stack.to(torch.bfloat16), cfg, h, w
    )
    valid = response > 0.0

    # Orientation and descriptors from ONE blurred patch extraction.
    blurred = gaussian_blur(stack)
    bpatch = extract_patches(blurred, uv_lvl, level)
    angle = keypoint_angles(bpatch)
    bits = _brief_bits(bpatch, angle)
    weights = torch.tensor(
        [1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32, device=img.device
    )
    desc = (bits.reshape(-1, 32, 8).to(torch.int32) * weights).sum(-1).to(torch.uint8)

    uv0 = uv_lvl * level_scale[level.to(torch.int64)][:, None]
    return OrbFeatures(
        uv=uv0, uv_lvl=uv_lvl, level=level, response=response, angle=angle,
        desc=desc, valid=valid,
    )

