"""Descriptor matching on masked distance matrices (port of
``pslam_tpu/ops/match.py``).

Hamming distance via the +/-1 trick: for descriptors unpacked to {-1, +1},
dot(a, b) = n_bits - 2 * hamming. The plain version runs the dot as an f32
matmul, which is exact here (|dot| <= 256 and TF32 is off package-wide).
Ties go to the lowest index everywhere (``lax.top_k`` / ``argmin`` order).
"""

from __future__ import annotations

import math

import torch

N_BITS = 256
# Reference match gates (ORBmatcher.cc:37-38).
TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30  # rotation-consistency histogram (ORBmatcher.cc:39)
BIG = 1 << 20


def unpack_bits(desc_u8):
    """(N, 32) uint8 -> (N, 256) float32 in {-1, +1} (bit order LSB-first)."""
    shifts = torch.arange(8, device=desc_u8.device, dtype=torch.uint8)
    bits = (desc_u8[..., None] >> shifts) & 1
    return bits.reshape(desc_u8.shape[:-1] + (N_BITS,)).to(torch.float32) * 2 - 1


def hamming_matrix(desc_a, desc_b):
    """(Na, 32) x (Nb, 32) packed uint8 -> (Na, Nb) int32 Hamming distances."""
    dot = unpack_bits(desc_a) @ unpack_bits(desc_b).T
    return torch.div(N_BITS - dot.to(torch.int32), 2, rounding_mode="floor")


def rotation_consistency_mask(angle_a, angle_b, pair_mask):
    """Keep only pairs in the 3 dominant rotation-difference bins
    (ComputeThreeMaxima, ORBmatcher.cc:1601-1643); bins below 10% of the max
    are dropped like the reference."""
    diff = torch.remainder(angle_a - angle_b, 2.0 * math.pi)
    bin_idx = torch.clamp(
        (diff * (HISTO_BINS / (2.0 * math.pi))).to(torch.int32), 0, HISTO_BINS - 1
    ).to(torch.int64)
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=diff.device)
    hist.index_add_(0, bin_idx, pair_mask.to(torch.int32))
    top3_v, top3_i = torch.sort(hist, descending=True, stable=True)
    ar = torch.arange(HISTO_BINS, device=diff.device)
    keep_bin = torch.zeros(HISTO_BINS, dtype=torch.bool, device=diff.device)
    floor = torch.clamp((0.1 * top3_v[0]).to(torch.int32), min=1)
    for j in range(3):
        keep_bin = keep_bin | ((ar == top3_i[j]) & (top3_v[j] >= floor))
    return pair_mask & keep_bin[bin_idx]


def row_col_minima(d):
    """Row best / second-best / best column and column min / argmin of an
    (Na, Nb) int32 distance matrix, ties to the lowest index. Rows with no
    candidate (all >= BIG) get best = second = BIG and best_j = -1."""
    best, best_j = torch.min(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    d2 = d.clone()
    d2[rows, best_j] = BIG
    second = torch.min(d2, dim=1).values if d.shape[1] > 1 else torch.full_like(best, BIG)
    best = torch.clamp(best, max=BIG)
    second = torch.clamp(second, max=BIG)
    best_j = torch.where(best >= BIG, -1, best_j)
    col_min, col_arg = torch.min(d, dim=0)
    return best, second, best_j, torch.clamp(col_min, max=BIG), col_arg


def accept_matches(best, second, best_j, col_arg, max_dist, ratio):
    """Max-distance, Lowe-ratio and mutual acceptance. Returns (match_idx
    (Na,) int64 column or -1)."""
    Na = best.shape[0]
    Nb = col_arg.shape[0]
    mutual = col_arg[torch.clamp(best_j, 0, Nb - 1)] == torch.arange(
        Na, device=best.device
    )
    ok = (
        (best <= max_dist)
        & (best.to(torch.float32) < ratio * second.to(torch.float32))
        & mutual
        & (best_j >= 0)
    )
    return torch.where(ok, best_j, -1)


def mutual_nn_match(
    dist,
    valid_a=None,
    valid_b=None,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
    extra_mask=None,
):
    """Mutual nearest-neighbour matching with Lowe ratio on a distance matrix.

    dist: (Na, Nb) int32. Returns (match_idx (Na,) int64 column or -1,
    best_dist (Na,) int32)."""
    d = dist
    big = torch.tensor(BIG, dtype=d.dtype, device=d.device)
    if extra_mask is not None:
        d = torch.where(extra_mask, d, big)
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, big)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, big)
    best, second, best_j, _, col_arg = row_col_minima(d)
    return accept_matches(best, second, best_j, col_arg, max_dist, ratio), best


def window_mask(uv_a, uv_b, radius):
    """(Na, 2) x (Nb, 2) -> (Na, Nb) bool: |du|,|dv| within radius (scalar or
    (Na,) per-query radius)."""
    du = torch.abs(uv_a[:, None, 0] - uv_b[None, :, 0])
    dv = torch.abs(uv_a[:, None, 1] - uv_b[None, :, 1])
    r = torch.as_tensor(radius, dtype=uv_a.dtype, device=uv_a.device)
    if r.ndim == 1:
        r = r[:, None]
    return (du <= r) & (dv <= r)


def level_window_mask(level_a, level_b, lo_off: int, hi_off: int):
    """Octave compatibility mask: level_b in [level_a+lo_off, level_a+hi_off]."""
    lb = level_b[None, :]
    la = level_a[:, None]
    return (lb >= la + lo_off) & (lb <= la + hi_off)
