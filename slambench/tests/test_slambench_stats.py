"""The frozen metric arithmetic and counts on fixed inputs."""

import math

import numpy as np
import pytest

from slambench import reference, stats


def test_ate_of_a_rigidly_moved_trajectory_is_zero():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(20, 3))
    a = 0.3
    R = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    est = gt @ R.T + np.array([1.0, -2.0, 0.5])
    assert stats.ate_rmse(est, gt) < 1e-12


def test_ate_of_a_known_offset():
    gt = np.zeros((4, 3))
    gt[:, 0] = [0, 1, 2, 3]
    est = gt.copy()
    est[:, 1] = [0.1, -0.1, -0.1, 0.1]  # uncorrelated with x: no rotation helps
    assert stats.ate_rmse(est, gt) == pytest.approx(0.1, rel=1e-9)


def test_trajectory_positions():
    T = np.eye(4)[None].repeat(2, 0)
    T[1, :3, 3] = [1.0, 2.0, 3.0]
    np.testing.assert_allclose(stats.trajectory_positions(T), [[0, 0, 0], [-1, -2, -3]])


def test_p90_and_rate():
    assert stats.p90(range(1, 12)) == pytest.approx(10.0)
    assert stats.p90([5.0]) == 5.0
    assert stats.rate(90, 45.0) == 2.0


def test_kernel_counts_and_peaks():
    # K2 at E = 4096 moves 148,140 bytes (chip_smoke.py, phase 3).
    assert stats.k2_bytes(4096) == 148140
    assert stats.k2_ops(4096) == 280 * 4096
    assert stats.k1_bytes(4096, 1000) == 76 * 4096 + 72 * 1000
    assert stats.k1_ops(4096, 1000, 10) == 9 * 4096 * 1000 + 240
    # K1 at 4096 x 1000 is bound by operations: 0.5514 us (PERF.md).
    f = stats.floor_s(stats.k1_bytes(4096, 1000), stats.k1_ops(4096, 1000, 0))
    assert f == pytest.approx(9 * 4096 * 1000 / 67e12)
    assert stats.floor_s(stats.k2_bytes(4096), stats.k2_ops(4096)) == pytest.approx(148140 / 3.35e12)


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 3.14159265, -2.5e-3], np.float32)
    r = reference.tf32_round(x)
    assert r[0] == 1.0 and r[2] == np.float32(1.0 + 2**-10)
    assert r[1] == 1.0  # a tie rounds to even
    bits = r.view(np.uint32)
    assert np.all(bits & 0x1FFF == 0)
    assert np.all(np.abs(r - x) <= np.abs(x) * 2**-11)


def test_orthonormality_and_surface_distance():
    T = np.eye(4)[None].repeat(2, 0)
    T[1, 0, 0] = 1.001
    o = reference.orthonormality(T)
    assert o[0] == 0 and o[1] == pytest.approx(1.001**2 - 1)
    room = dict(depth=3.5, half_w=3.0, half_h=2.0)
    d = reference.surface_distance(room, [[2.9, 0, 0], [0, 0, 3.6], [0, 0, 1.0]])
    np.testing.assert_allclose(d, [0.1, 0.1, 2.0])


def test_chained_poses_follow_the_truth_and_tf32_drifts():
    import json

    from slambench.traffic import path_poses

    from .conftest import BENCH

    tr = json.loads((BENCH / "traffic" / "fr1desk.json").read_text())
    poses = path_poses(tr)[:60]
    np.testing.assert_allclose(reference.chained_poses(poses), poses, atol=1e-12)
    drift = reference.orthonormality(reference.chained_poses(poses, tf32=True))
    assert drift[0] < 1e-6 < 1e-4 < drift[-1]


def test_rpe_of_a_constant_offset_is_zero_and_of_a_jump_is_the_jump():
    T = np.eye(4)[None].repeat(5, 0)
    T[:, 0, 3] = np.arange(5) * 0.01
    est = T.copy()
    est[:, 1, 3] += 0.3  # the same offset on every frame: no relative error
    np.testing.assert_allclose(stats.rpe_mm(est, T), 0.0, atol=1e-9)
    est[3, 2, 3] += 0.002  # one frame 2 mm off: two relative motions err by 2 mm
    np.testing.assert_allclose(stats.rpe_mm(est, T), [0, 0, 2, 2], atol=1e-9)


def test_ate_ratio_reads_one_for_a_pose_held_still_and_zero_for_the_truth():
    from slambench import check

    rng = np.random.default_rng(3)
    gt = np.repeat(np.eye(4)[None], 30, 0)
    gt[:, :3, 3] = rng.normal(scale=0.05, size=(30, 3))
    held = np.repeat(gt[7:8], 30, 0)
    assert check.ate_ratio(held, gt) == pytest.approx(1.0, rel=1e-12)
    assert check.ate_ratio(gt, gt) < 1e-12
    assert check.ate_ratio(gt[:2], gt[:2]) == float("inf")
