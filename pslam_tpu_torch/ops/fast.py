"""FAST-16 corner response over a level stack (port of
``pslam_tpu/ops/fast.py``).

The segment test and contrast score are computed for every pixel of every
level at both thresholds in one pass of 16 shifted comparisons. Like the JAX
package, the pass runs in bfloat16: the cast, each difference and each
running score sum round to bf16 in the same order, so both packages make the
same corner decisions on the same stack.
"""

from __future__ import annotations

import numpy as np
import torch

# Bresenham circle of radius 3: 16 (dx, dy) offsets in cyclic (clockwise)
# order starting at 12 o'clock — the standard FAST-16 test geometry.
CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


def _shift2d(img, dy: int, dx: int):
    """Cyclic shift of (..., H, W) by (dy, dx) (borders are masked later)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _arc9_from_bits(m):
    """int32 16-bit ring mask -> True where a contiguous arc of >= 9 is set
    (log-step shift-ANDs: runs >= 2 -> >= 4 -> >= 8 -> >= 9)."""
    mm = m | (m << 16)  # unwrap the cycle
    r = mm & (mm >> 1)
    r = r & (r >> 2)
    r = r & (r >> 4)
    r = r & (mm >> 8)
    return (r & 0xFFFF) != 0


def fast_score_dual(stack, th_hi: int, th_lo: int):
    """One-pass FAST at BOTH thresholds + the low-threshold ranking score.

    Returns (corner_hi, corner_lo, score_lo) with score_lo in the input
    dtype. The comparisons run on a bf16 copy of ``stack``."""
    out_dtype = stack.dtype
    stack = stack.to(torch.bfloat16)
    t_lo = torch.tensor(th_lo, dtype=torch.bfloat16, device=stack.device)
    t_hi = torch.tensor(th_hi, dtype=torch.bfloat16, device=stack.device)

    m_hi_b = torch.zeros(stack.shape, dtype=torch.int32, device=stack.device)
    m_hi_d = torch.zeros_like(m_hi_b)
    m_lo_b = torch.zeros_like(m_hi_b)
    m_lo_d = torch.zeros_like(m_hi_b)
    score_b = torch.zeros_like(stack)
    score_d = torch.zeros_like(stack)
    zero = torch.zeros((), dtype=torch.bfloat16, device=stack.device)
    for s, (dx, dy) in enumerate(CIRCLE):
        diff = _shift2d(stack, int(dy), int(dx)) - stack
        bit = 1 << s
        b_lo = diff > t_lo
        d_lo = diff < -t_lo
        m_lo_b |= b_lo.to(torch.int32) * bit
        m_lo_d |= d_lo.to(torch.int32) * bit
        m_hi_b |= (diff > t_hi).to(torch.int32) * bit
        m_hi_d |= (diff < -t_hi).to(torch.int32) * bit
        excess = torch.abs(diff) - t_lo
        score_b = score_b + torch.where(b_lo, excess, zero)
        score_d = score_d + torch.where(d_lo, excess, zero)

    corner_hi = _arc9_from_bits(m_hi_b) | _arc9_from_bits(m_hi_d)
    corner_lo = _arc9_from_bits(m_lo_b) | _arc9_from_bits(m_lo_d)
    score_lo = torch.maximum(score_b, score_d).to(out_dtype)
    return corner_hi, corner_lo, score_lo


def fast_score(stack, threshold: int):
    """Segment test + score for each pixel, in the input dtype (the JAX
    package's ``fast_score``; the tracker uses ``fast_score_dual``).

    stack: (..., H, W) float32 intensities.
    Returns (is_corner (..., H, W) bool, score (..., H, W)) where score is
    the sum of |I_p - I_center| - threshold over circle pixels on the
    dominant (brighter/darker) arc side, the ranking statistic cv::FAST uses.
    Border pixels (3px) are NOT masked here."""
    t = torch.tensor(threshold, dtype=stack.dtype, device=stack.device)
    zero = torch.zeros((), dtype=stack.dtype, device=stack.device)
    m_b = torch.zeros(stack.shape, dtype=torch.int32, device=stack.device)
    m_d = torch.zeros_like(m_b)
    excess_b, excess_d = [], []
    for s, (dx, dy) in enumerate(CIRCLE):
        diff = _shift2d(stack, int(dy), int(dx)) - stack
        brighter, darker = diff > t, diff < -t
        m_b |= brighter.to(torch.int32) << s
        m_d |= darker.to(torch.int32) << s
        excess = torch.abs(diff) - t
        excess_b.append(torch.where(brighter, excess, zero))
        excess_d.append(torch.where(darker, excess, zero))
    is_corner = _arc9_from_bits(m_b) | _arc9_from_bits(m_d)
    score = torch.maximum(torch.stack(excess_b).sum(0), torch.stack(excess_d).sum(0))
    return is_corner, score


def nms3x3(score):
    """3x3 non-maximum suppression mask for (L, H, W) scores (-inf padding).
    The max is exact in any dtype, so it is taken on an f32 copy."""
    s = score.float()
    neigh_max = torch.nn.functional.max_pool2d(
        s[:, None], kernel_size=3, stride=1, padding=1
    )[:, 0]
    return s >= neigh_max
