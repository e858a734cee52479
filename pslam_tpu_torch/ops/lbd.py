"""Line band descriptors (LBD-style) as one batched sampling + reduction
(port of ``pslam_tpu/ops/lbd.py``).

Replaces the reference's BinaryDescriptor (used via LINEextractor,
add_src/LineExtractor.cpp:348-350): the support region is split into bands
parallel to the line; each band is described by the mean and standard
deviation of the gradient in the line frame. As in the JAX package the
descriptor stays float (unit-normalized, matched as squared L2) and sampling
is a fixed (S along x C across) grid scaled to the segment length.
"""

from __future__ import annotations

import numpy as np
import torch

from pslam_tpu_torch.ops.lines import image_gradients

S_ALONG = 16  # samples along the line
N_BANDS = 5
BAND_PX = 3  # band width in px
C_ACROSS = N_BANDS * BAND_PX  # perpendicular samples
DESC_DIM = N_BANDS * 8  # mean(4) + std(4) per band


def _across_weights(device):
    """Global Gaussian over the across-line offset (LBD's f_g)."""
    off = np.arange(C_ACROSS) - (C_ACROSS - 1) / 2.0
    sigma = C_ACROSS / 2.0
    w = np.exp(-0.5 * (off / sigma) ** 2)
    return (
        torch.from_numpy((w / w.sum()).astype(np.float32)).to(device),
        torch.from_numpy(off.astype(np.float32)).to(device),
    )


def _unit_rows(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


def line_descriptors(img, sp, ep, valid):
    """img (H, W) float32; sp/ep (NL, 2); valid (NL,) -> (NL, DESC_DIM).
    Invalid lines get zero descriptors."""
    h, w = img.shape
    gx, gy = image_gradients(img)

    d = ep - sp
    length = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-9)
    dirs = d / length[:, None]
    nrm = torch.stack([-dirs[:, 1], dirs[:, 0]], dim=-1)

    w_g, off = _across_weights(img.device)
    t = torch.linspace(0.0, 1.0, S_ALONG, device=img.device)
    base = sp[:, None, :] + t[None, :, None] * d[:, None, :]  # (NL, S, 2)
    pts = base[:, :, None, :] + off[None, None, :, None] * nrm[:, None, None, :]

    xi = torch.clamp(torch.round(pts[..., 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(pts[..., 1]).to(torch.int64), 0, h - 1)
    gxs = gx[yi, xi]  # (NL, S, C)
    gys = gy[yi, xi]

    g_par = gxs * dirs[:, None, None, 0] + gys * dirs[:, None, None, 1]
    g_per = gxs * nrm[:, None, None, 0] + gys * nrm[:, None, None, 1]

    # 4 half-wave channels per sample (LBD's banded gradient statistics).
    feats = torch.stack(
        [
            torch.clamp(g_per, min=0.0),
            torch.clamp(-g_per, min=0.0),
            torch.clamp(g_par, min=0.0),
            torch.clamp(-g_par, min=0.0),
        ],
        dim=-1,
    ) * w_g[None, None, :, None]

    bands = feats.reshape(feats.shape[0], S_ALONG, N_BANDS, BAND_PX, 4)
    col = torch.sum(bands, dim=3)  # (NL, S, B, 4)
    mean = torch.mean(col, dim=1)
    std = torch.std(col, dim=1, correction=0)  # population std, as jnp.std
    desc = torch.cat([mean, std], dim=-1).reshape(-1, DESC_DIM)

    # Unit-normalize, clip spikes like LBD, normalize again.
    desc = _unit_rows(torch.clamp(_unit_rows(desc), 0.0, 0.4))
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def line_dist_matrix(desc_a, desc_b):
    """(Na, D) x (Nb, D) unit descriptors -> (Na, Nb) squared L2 in [0, 4]:
    ||a - b||^2 = 2 - 2 a.b."""
    return torch.clamp(2.0 - 2.0 * (desc_a @ desc_b.T), min=0.0)
