"""The PyTorch port stands alone: every module of ``pslam_tpu_torch`` imports
with ``jax`` and ``pslam_tpu`` blocked, and no file of the package imports
JAX. Exact checks (no tolerance)."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import pslam_tpu_torch

PKG_DIR = Path(pslam_tpu_torch.__file__).parent
MODULES = sorted(
    m.name
    for m in pkgutil.walk_packages([str(PKG_DIR)], prefix="pslam_tpu_torch.")
)


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jax.numpy', 'jaxlib', 'pslam_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok', len(" + repr(MODULES) + "))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(PKG_DIR.parent), timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_walk_covers_io_apps_parallel_and_trace():
    """The modules ported last are among those imported with JAX blocked."""
    for name in ("apps.rgbd_tum", "apps.visualize", "apps.evaluate", "apps.run_long",
                 "apps.ate_ladder", "apps.lowtex", "apps.profile_frame",
                 "apps.profile_backend", "apps.roofline", "io.tum", "parallel.sharded_ba",
                 "parallel.sharded_graph", "utils.trace", "utils.profile"):
        assert f"pslam_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize("path", sorted(PKG_DIR.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    text = path.read_text()
    for needle in ("import jax", "from jax", "import pslam_tpu\n", "from pslam_tpu."):
        assert needle not in text, f"{path} contains {needle!r}"


def test_package_turns_tf32_off():
    import torch

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_sources_present():
    for name in ("fused_match", "fused_pose"):
        src = PKG_DIR / "csrc" / f"{name}.cu"
        assert src.exists()
        head = src.read_text().split("#include")[0]
        # Each kernel opens with the note naming the TPU kernel it replaces.
        assert "pslam_tpu/ops/pallas_" in head
