"""Parity of kernel K1's plain version (``ops/fused_match.py``) against the
JAX package: ``projection_match(..., interpret=True)`` (the Pallas kernel in
interpret mode) and the jnp path (window_mask + level_window_mask +
hamming_matrix + mutual_nn_match). Match indices and distances must be
exactly equal (integer outputs, exact arithmetic on both sides). Shapes are
those of tests/test_pallas_match.py plus a case with planted duplicate
descriptors that forces distance ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.ops.match import (
    hamming_matrix as j_hamming,
    level_window_mask as j_level_mask,
    mutual_nn_match as j_mutual,
    window_mask as j_window,
)
from pslam_tpu.ops.pallas_match import (
    BIG,
    fused_projection_match as j_fused,
    projection_match as j_projection_match,
)
from pslam_tpu.ops.match import unpack_bits as j_unpack
from pslam_tpu_torch.ops import fused_match
from pslam_tpu_torch.ops.match import hamming_matrix as t_hamming


def _case(na, nb, seed, ties=False):
    rng = np.random.default_rng(seed)
    desc_a = rng.integers(0, 256, (na, 32), dtype=np.uint8)
    desc_b = rng.integers(0, 256, (nb, 32), dtype=np.uint8)
    plant = rng.permutation(min(na, nb))[: min(na, nb) // 2]
    for i, j in enumerate(plant):
        desc_b[j] = desc_a[i]
        flip = rng.integers(0, 32)
        desc_b[j, flip] ^= np.uint8(1 << rng.integers(0, 8))
    uv_a = rng.uniform(0, 640, (na, 2)).astype(np.float32)
    uv_b = uv_a[rng.integers(0, na, nb)] + rng.normal(0, 6, (nb, 2)).astype(np.float32)
    lev_a = rng.integers(0, 8, na).astype(np.int32)
    lev_b = rng.integers(0, 8, nb).astype(np.int32)
    for i, j in enumerate(plant):
        uv_b[j] = uv_a[i] + rng.normal(0, 2, 2).astype(np.float32)
        lev_b[j] = lev_a[i]
    if ties:
        # Exact duplicates on both sides inside one window: equal best
        # distances in a row (lowest column wins, second == best) and in a
        # column (lowest row wins).
        for i in range(0, min(na, nb) // 4, 2):
            j = int(plant[i])
            j2 = (j + 1) % nb
            desc_b[j2] = desc_b[j]
            uv_b[j2] = uv_b[j] + 0.5
            lev_b[j2] = lev_b[j]
            desc_a[i + 1] = desc_a[i]
            uv_a[i + 1] = uv_a[i] + 0.25
            lev_a[i + 1] = lev_a[i]
    val_a = rng.uniform(size=na) > 0.1
    val_b = rng.uniform(size=nb) > 0.1
    radius = rng.uniform(5, 25, na).astype(np.float32)
    return desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b, radius


CASES = [(200, 300, 0, False), (128, 128, 1, False), (50, 700, 2, False),
         (160, 240, 3, True)]


@pytest.mark.parametrize("na,nb,seed,ties", CASES)
def test_projection_match_exact(na, nb, seed, ties):
    desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b, radius = _case(
        na, nb, seed, ties
    )
    J = jnp.asarray
    idx_pl, d_pl = j_projection_match(
        J(uv_a), J(radius), J(lev_a - 1), J(lev_a + 1), J(val_a), J(desc_a),
        J(uv_b), J(lev_b), J(val_b), J(desc_b),
        max_dist=100, ratio=0.9, interpret=True,
    )
    box = j_window(J(uv_a), J(uv_b), J(radius))
    lvl = j_level_mask(J(lev_a), J(lev_b), -1, 1)
    idx_ref, d_ref = j_mutual(
        j_hamming(J(desc_a), J(desc_b)), valid_a=J(val_a), valid_b=J(val_b),
        max_dist=100, ratio=0.9, extra_mask=box & lvl,
    )
    T = torch.from_numpy
    before = fused_match.LAUNCHES
    idx_t, d_t = fused_match.projection_match(
        T(uv_a), T(radius), T(lev_a - 1), T(lev_a + 1), T(val_a), T(desc_a),
        T(uv_b), T(lev_b), T(val_b), T(desc_b), max_dist=100, ratio=0.9,
    )
    assert fused_match.LAUNCHES == before  # CPU tensors take the plain path
    idx_t, d_t = idx_t.numpy(), d_t.numpy()
    np.testing.assert_array_equal(idx_t, np.asarray(idx_pl))
    np.testing.assert_array_equal(idx_t, np.asarray(idx_ref))
    both = idx_t >= 0
    np.testing.assert_array_equal(d_t[both], np.asarray(d_pl)[both])
    np.testing.assert_array_equal(d_t, np.asarray(d_ref))
    assert both.sum() > 0


@pytest.mark.parametrize("na,nb,seed,ties", CASES)
def test_kernel_core_outputs_exact(na, nb, seed, ties):
    """best, second, best_j and col_min equal the Pallas kernel's;
    col_argmin wherever the column has a candidate (unspecified otherwise,
    on the TPU as here)."""
    desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b, radius = _case(
        na, nb, seed, ties
    )
    T = torch.from_numpy
    a_par, b_par = fused_match.pack_params(
        T(uv_a), T(radius), T(lev_a - 1), T(lev_a + 1), T(val_a),
        T(uv_b), T(lev_b), T(val_b),
    )
    out_t = [o.numpy() for o in fused_match.fused_projection_match(
        T(desc_a), a_par, T(desc_b), b_par)]
    out_j = [np.asarray(o) for o in j_fused(
        j_unpack(jnp.asarray(desc_a)), jnp.asarray(a_par.numpy()),
        j_unpack(jnp.asarray(desc_b)), jnp.asarray(b_par.numpy()), interpret=True)]
    for k in range(4):
        np.testing.assert_array_equal(out_t[k], out_j[k])
    has = out_j[3] < BIG
    np.testing.assert_array_equal(out_t[4][has], out_j[4][has])
    if ties:
        # The planted duplicates really produced ties.
        assert (out_t[0] == out_t[1])[out_t[0] < BIG].any()


def test_hamming_matrix_exact():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (33, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (21, 32), dtype=np.uint8)
    ref = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)
    got = t_hamming(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(j_hamming(jnp.asarray(a), jnp.asarray(b))))


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only CPU tensors run the plain version; any other device goes to the
    kernel's checks (here a meta tensor, which they refuse) and never
    silently computes the plain result."""
    meta = dict(device="meta")
    desc = torch.empty((8, 32), dtype=torch.uint8, **meta)
    par = torch.empty((8, 8), dtype=torch.float32, **meta)
    before = fused_match.LAUNCHES
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fused_match.fused_projection_match(desc, par, desc, par)
    assert fused_match.LAUNCHES == before


@pytest.mark.parametrize("failure", ["no_nvcc", "nvcc_fails"])
def test_kernel_build_failure_raises(failure, monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    import shutil

    import torch.utils.cpp_extension as cpp_ext

    from pslam_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    if failure == "no_nvcc":
        monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
        monkeypatch.setattr(shutil, "which", lambda name: None)
        match = "nvcc not found"
    else:
        monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false") or "/bin/false")
        match = "nvcc failed for fused_match.cu"
    with pytest.raises(RuntimeError, match=match):
        _build.library("fused_match")
    # A failed build leaves no library behind.
    assert not list((tmp_path / "build").glob("*.so"))
