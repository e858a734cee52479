"""Fused projection matcher: kernel K1 (port of ``pslam_tpu/ops/pallas_match.py``).

``fused_projection_match`` returns, for Na projected map points (A) against
Nb frame features (B) under the box window, the octave window and both
validity flags: per row the best and second-best Hamming distance and the
best column, per column the min distance and its row (ties to the lowest
index; BIG = 2^20 where there is no candidate). On CUDA tensors it launches
the hand-written kernel ``csrc/fused_match.cu``; on CPU tensors it runs
``fused_projection_match_plain`` (window masks -> Hamming matrix -> minima).
There is no other path: a CUDA launch that fails raises.

Parameter packing (as in the JAX module):
    a_par: (8, Na) f32 rows [u, v, radius, lev_lo, lev_hi, valid, 0, 0]
    b_par: (8, Nb) f32 rows [u, v, level, valid, 0, 0, 0, 0]
"""

from __future__ import annotations

import ctypes

import torch

from pslam_tpu_torch.ops import _build
from pslam_tpu_torch.ops.match import (
    BIG,
    accept_matches,
    hamming_matrix,
    row_col_minima,
)

# Kernel launches since import (or since a caller reset it to 0). The plain
# CPU path does not count.
LAUNCHES = 0

# The C interface of csrc/fused_match.cu: function name -> argtypes.
ARGTYPES = {
    "pslam_fused_match": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                         + [ctypes.c_void_p] * 8,
    "pslam_fused_match_slabs": [ctypes.c_int],
}

_c_fns = None


def _kernel():
    global _c_fns
    if _c_fns is None:
        _c_fns = _build.bind("fused_match", ARGTYPES)
    return _c_fns


def pack_params(uv_a, radius_a, lev_lo_a, lev_hi_a, valid_a, uv_b, level_b, valid_b):
    """Per-point parameters -> (a_par (8, Na), b_par (8, Nb)) f32."""
    Na, Nb = uv_a.shape[0], uv_b.shape[0]
    zeros_a = torch.zeros(Na, dtype=torch.float32, device=uv_a.device)
    radius = torch.as_tensor(radius_a, dtype=torch.float32, device=uv_a.device)
    a_par = torch.stack([
        uv_a[:, 0], uv_a[:, 1], radius.expand(Na),
        lev_lo_a.to(torch.float32), lev_hi_a.to(torch.float32),
        valid_a.to(torch.float32), zeros_a, zeros_a,
    ])
    zeros_b = torch.zeros(Nb, dtype=torch.float32, device=uv_b.device)
    b_par = torch.stack([
        uv_b[:, 0], uv_b[:, 1], level_b.to(torch.float32),
        valid_b.to(torch.float32), zeros_b, zeros_b, zeros_b, zeros_b,
    ])
    return a_par.contiguous(), b_par.contiguous()


def fused_projection_match_plain(desc_a, a_par, desc_b, b_par):
    """Plain PyTorch version: (Na, Nb) masks and Hamming matrix, reduced."""
    au, av, ar, alo, ahi = (a_par[k][:, None] for k in range(5))
    aok = a_par[5][:, None] > 0.5
    bu, bv, bl = (b_par[k][None, :] for k in range(3))
    bok = b_par[3][None, :] > 0.5
    mask = (
        (torch.abs(au - bu) <= ar) & (torch.abs(av - bv) <= ar)
        & (bl >= alo) & (bl <= ahi) & aok & bok
    )
    d = torch.where(mask, hamming_matrix(desc_a, desc_b), BIG)
    best, second, best_j, col_min, col_arg = row_col_minima(d)
    return (best.to(torch.int32), second.to(torch.int32), best_j.to(torch.int32),
            col_min.to(torch.int32), col_arg.to(torch.int32))


def fused_projection_match(desc_a, a_par, desc_b, b_par):
    """desc_* (N, 32) uint8, *_par (8, N) f32 -> (best, second, best_j,
    col_min, col_argmin), all int32. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    global LAUNCHES
    if desc_a.device.type == "cpu":
        return fused_projection_match_plain(desc_a, a_par, desc_b, b_par)
    Na, Nb = desc_a.shape[0], desc_b.shape[0]
    _build.check_cuda(desc_a, "desc_a", torch.uint8, (Na, 32))
    _build.check_cuda(desc_b, "desc_b", torch.uint8, (Nb, 32))
    _build.check_cuda(a_par, "a_par", torch.float32, (8, Na))
    _build.check_cuda(b_par, "b_par", torch.float32, (8, Nb))
    for t, name in ((desc_a, "desc_a"), (desc_b, "desc_b")):
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: descriptors must be 4-byte aligned")
    dev = desc_a.device
    best = torch.empty(Na, dtype=torch.int32, device=dev)
    second = torch.empty(Na, dtype=torch.int32, device=dev)
    best_j = torch.empty(Na, dtype=torch.int32, device=dev)
    col_min = torch.empty(Nb, dtype=torch.int32, device=dev)
    col_arg = torch.empty(Nb, dtype=torch.int32, device=dev)
    fns = _kernel()
    # Scratch: per column slab, each row's (best, second, best column).
    slabs = fns["pslam_fused_match_slabs"](Nb)
    row_part = torch.empty((3, slabs, Na), dtype=torch.int32, device=dev)
    col_key = torch.empty(Nb, dtype=torch.int64, device=dev)
    rc = fns["pslam_fused_match"](
        desc_a.data_ptr(), a_par.data_ptr(), Na,
        desc_b.data_ptr(), b_par.data_ptr(), Nb,
        best.data_ptr(), second.data_ptr(), best_j.data_ptr(),
        col_min.data_ptr(), col_arg.data_ptr(), row_part.data_ptr(),
        col_key.data_ptr(), _build.stream_ptr(desc_a),
    )
    if rc != 0:
        raise RuntimeError(f"fused_match kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return best, second, best_j, col_min, col_arg


def projection_match(
    uv_a, radius_a, lev_lo_a, lev_hi_a, valid_a, desc_a,
    uv_b, level_b, valid_b, desc_b,
    *, max_dist: int = 100, ratio: float = 0.9,
):
    """Fused equivalent of window_mask + level_window_mask + hamming_matrix +
    mutual_nn_match (ops/match.py) for projection search. desc_* are packed
    (N, 32) uint8. Returns (match_idx (Na,) int64 or -1, best_dist (Na,))."""
    a_par, b_par = pack_params(
        uv_a, radius_a, lev_lo_a, lev_hi_a, valid_a, uv_b, level_b, valid_b
    )
    best, second, best_j, _, col_arg = fused_projection_match(
        desc_a.contiguous(), a_par, desc_b.contiguous(), b_par
    )
    idx = accept_matches(
        best, second, best_j.to(torch.int64), col_arg.to(torch.int64),
        max_dist, ratio,
    )
    return idx, best
