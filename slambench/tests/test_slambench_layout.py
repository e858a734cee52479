"""Every entry of BENCHMARK.json resolves to files of its own, found by
name; the runs load no JAX; the reference imports nothing of the
program."""

import ast
import json
import subprocess
import sys

import pytest

from slambench import harness
from slambench.trace import resolve

from .conftest import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    w, cfg, traffic, e2e, per_layer = harness.resolve_cell(cell)
    assert {m["name"] for m in e2e} >= {"setup_s", "frames_per_s", "frame_ms_p90"}
    assert per_layer
    conf = harness.slam_config(cfg)
    assert conf.camera.width == 640 and conf.orb.n_features == 1000
    checks = harness_checks()
    assert set(cfg["limits"]) <= set(checks) and set(checks[:7]) <= set(cfg["limits"])
    assert traffic["warm_frames"] > 0 and traffic["head_frames"] > 0


def harness_checks():
    from slambench.check import CHECKS

    return CHECKS


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    r = harness.layer_reader(metric)
    assert callable(r.read)
    for target, name, *cap in r.SPANS:
        owner, attr = resolve(target)
        assert callable(getattr(owner, attr))


def test_config_files_hold_what_they_list():
    for c in SPEC["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])
    moves = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in moves for m in SPEC["per_layer"])


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["pslam_tpu_torch", "pslam_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(["pslam_tpu.ops.x", "jaxlib", "jax_foo"]) == ["jaxlib",
                                                                                   "pslam_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from slambench import harness, check, scene, trace\n"
            "import pslam_tpu_torch.pipeline.system, pslam_tpu_torch.ops.fused_match\n"
            "print(harness.forbidden_modules())" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
    code = code.replace("import pslam_tpu_torch.pipeline.system", "import pslam_tpu.utils")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert "pslam_tpu" in out.stdout


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "stats.py"):
        tree = ast.parse((BENCH / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not any(m.split(".")[0] in ("pslam_tpu_torch", "pslam_tpu", "jax", "torch")
                       for m in mods), (name, mods)


def test_run_without_the_port_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "slambench")
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "points-fr2xyz",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
