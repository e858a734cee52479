"""Image pyramid and blur ops (port of ``pslam_tpu/ops/image.py``).

All pyramid levels live on one (L, H, W) canvas, each level in its top-left
(h_l, w_l) corner; the rest of the canvas is zero and masked. The resize
matrices are built with numpy exactly as the JAX package builds them, so
both packages resample with identical constants.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PYR_LEVELS = 8
PYR_SCALE = 1.2  # reference ORBextractor.scaleFactor (TUM1.yaml:49)


def level_shapes(h: int, w: int, levels: int = PYR_LEVELS, scale: float = PYR_SCALE):
    """Concrete (h_l, w_l) per level, matching cv::resize round()."""
    out = []
    for l in range(levels):
        s = 1.0 / scale**l
        out.append((int(round(h * s)), int(round(w * s))))
    return out


def _resize_matrix_1d(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix (half-pixel centers, edge
    clamp)."""
    out = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        a = min(max(x0, 0), n_in - 1)
        b = min(max(x0 + 1, 0), n_in - 1)
        out[i, a] += 1.0 - f
        out[i, b] += f
    return out


@functools.lru_cache(maxsize=8)
def pyramid_matrices(h: int, w: int, levels: int, scale: float):
    """Composed per-level (row, col) interpolation matrices replicating the
    reference's successive level-from-previous-level resizes
    (ORBextractor.cc:1107-1129), padded to the canvas: (L, H, H), (L, W, W)
    numpy float32."""
    shapes = level_shapes(h, w, levels, scale)
    Rs, Cs = [], []
    R = np.eye(h, dtype=np.float32)
    C = np.eye(w, dtype=np.float32)
    prev = (h, w)
    for l, (hl, wl) in enumerate(shapes):
        if l > 0:
            R = _resize_matrix_1d(prev[0], hl) @ R
            C = _resize_matrix_1d(prev[1], wl) @ C
        prev = (hl, wl)
        Rp = np.zeros((h, h), np.float32)
        Rp[:hl] = R
        Cp = np.zeros((w, w), np.float32)
        Cp[:wl] = C
        Rs.append(Rp)
        Cs.append(Cp)
    return np.stack(Rs), np.stack(Cs)


@functools.lru_cache(maxsize=8)
def _pyramid_tensors(h: int, w: int, levels: int, scale: float, device):
    R, C = pyramid_matrices(h, w, levels, scale)
    return (
        torch.from_numpy(R).to(device),
        torch.from_numpy(C).transpose(1, 2).contiguous().to(device),
    )


def build_pyramid(img, levels: int = PYR_LEVELS, scale: float = PYR_SCALE):
    """img (H, W) float32 -> (stack (L, H, W), level_scale (L,)).

    Two batched f32 matmuls per level stack (TF32 is off package-wide)."""
    h, w = img.shape
    R, Ct = _pyramid_tensors(h, w, levels, scale, img.device)
    stack = torch.matmul(torch.matmul(R, img), Ct)
    level_scale = torch.tensor(
        [scale**l for l in range(levels)], dtype=img.dtype, device=img.device
    )
    return stack, level_scale


def _gaussian_kernel1d(ksize: int, sigma: float):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _fma_taps(tap, k):
    """sum_i k[i] * tap(i) in f32 with one rounding per tap: the second tap
    is a rounded product, every other tap a fused multiply-add onto the
    running sum. This is the order and rounding XLA's CPU backend gives the
    JAX package's shift-and-add (LLVM contracts each add into an FMA), so
    both packages blur bit-identically on the CPU. A product of two f32
    values is exact in f64, so each FMA is one f64 add rounded to f32."""
    acc = float(k[1]) * tap(1)
    for i in [0] + list(range(2, len(k))):
        acc = (tap(i).double() * float(k[i]) + acc.double()).float()
    return acc


def gaussian_blur(stack, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur on a level stack (L, H, W) (or (H, W)) with
    BORDER_REFLECT_101 (ORBextractor.cc:1063-1066), as shift-and-add over
    slices of a reflect-padded canvas."""
    squeeze = stack.ndim == 2
    if squeeze:
        stack = stack[None]
    k = _gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    H, W = stack.shape[-2:]
    x = torch.nn.functional.pad(stack, (0, 0, pad, pad), mode="reflect")
    y = _fma_taps(lambda i: x[:, i : i + H, :], k)
    y = torch.nn.functional.pad(y, (pad, pad, 0, 0), mode="reflect")
    out = _fma_taps(lambda i: y[:, :, i : i + W], k)
    return out[0] if squeeze else out


def gather_pixels(img, y, x):
    """img[round(y), round(x)] for (N,) coordinates, clamped to the image.
    (The TPU's one-hot matmul gather ``gather_pixels_matmul`` becomes plain
    indexing; the result is identical.)"""
    h, w = img.shape
    yi = torch.clamp(torch.round(y).to(torch.int64), 0, h - 1)
    xi = torch.clamp(torch.round(x).to(torch.int64), 0, w - 1)
    return img[yi, xi]
