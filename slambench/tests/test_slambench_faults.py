"""The comparison against planted faults and the control, driving the rest
of a run on the CPU at a small size (the look for a card skipped), each in a
process of its own (``drive.py``), so that the run's check for JAX holds.

A sound run comes out correct; the control (the reference computed in TF32
in the program's place) and each fault the cells can have
(``planted.py``) make ``correct`` false."""

import json
import subprocess
import sys

import numpy as np
import pytest

from slambench import check

from .conftest import BENCH, small_config, small_traffic

SEED = 2**31 + 7


def _drive(tmp_path, traffic="fr1desk", fault=None, control=0, pipelined=False):
    cfg, tr = tmp_path / "config.json", tmp_path / "traffic.json"
    cfg.write_text(json.dumps(small_config("tum1-points-pipelined" if pipelined
                                           else "tum1-points")))
    tr.write_text(json.dumps(small_traffic(traffic)))
    workload = f"points-{'pipelined-' if pipelined else ''}{traffic}"
    cmd = [sys.executable, str(BENCH / "tests" / "drive.py"), "--workload",
           workload, "--seeds", str(SEED), "--seconds", "4", "--device", "cpu",
           "--config", str(cfg), "--traffic", str(tr), "--control", str(control)]
    if fault:
        cmd += ["--fault", fault]
    out = subprocess.run(cmd, cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(s) for s in out.stdout.splitlines() if s.startswith('{"reading"')]
    assert len(lines) == 1, out.stdout[-4000:]
    return lines[0]["reading"], out.stderr


def test_sound_run_is_correct_and_control_fails(tmp_path):
    r, err = _drive(tmp_path, control=1)
    assert r["program_correct"], r["program"]
    assert r["control_correct"] is False, r["control"]
    limits = small_config()["limits"]
    assert any(r["control"][k] > limits[k] for k in ("pose_orth", "depth_rel_p99",
                                                     "desc_bits_mean"))
    assert r["control"]["depth_rel_p99"] > 3 * r["program"]["depth_rel_p99"]
    # The run's own lines judge the control: its rows are the last on stderr.
    assert "FAILED" in "".join(err.splitlines()[-len(check.CHECKS):])


@pytest.mark.parametrize("fault,traffic,fails", [
    ("state_unchanged", "fr1desk", "ate_head_ratio"),
    ("stale_pose", "fr2xyz", "ate_head_ratio"),
    ("half_left_out", "fr1desk", "depth_rel_p99"),
    ("answer_altered", "fr1desk", "depth_rel_p99"),
])
def test_faults_make_the_run_incorrect(tmp_path, fault, traffic, fails):
    r, _ = _drive(tmp_path, traffic, fault=fault)
    assert not r["program_correct"]
    v, lim = r["program"][fails], small_config()["limits"][fails]
    assert not np.isfinite(v) or v > lim, r["program"]


def test_pipelined_sound_run_is_correct_and_control_fails(tmp_path):
    r, err = _drive(tmp_path, control=1, pipelined=True)
    assert r["program_correct"] and r["attempted"] > 0, r["program"]
    assert r["control_correct"] is False, r["control"]
    assert "FAILED" in "".join(err.splitlines()[-len(check.CHECKS):])


@pytest.mark.parametrize("fault,fails", [
    ("state_unchanged", "ate_head_ratio"),
    ("stale_pose", "ate_head_ratio"),
    ("half_left_out", "depth_rel_p99"),
    ("answer_altered", "depth_rel_p99"),
])
def test_pipelined_faults_make_the_run_incorrect(tmp_path, fault, fails):
    r, _ = _drive(tmp_path, fault=fault, pipelined=True)
    assert not r["program_correct"]
    v, lim = r["program"][fails], small_config()["limits"][fails]
    assert not np.isfinite(v) or v > lim, r["program"]


def test_judge_rejects_what_is_not_finite():
    values = {k: 0.0 for k in check.CHECKS}
    values["kf_rel_cm"] = float("inf")
    ok, rows = check.judge(values, {k: 1.0 for k in check.CHECKS})
    assert not ok and [r[0] for r in rows if not r[3]] == ["kf_rel_cm"]
