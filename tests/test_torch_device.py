"""The port's entry points (``SlamSystem``, ``apps.rgbd_tum``) and its
converters from the JAX package's state run on the card unless the caller
asks for the CPU, and the ctypes bindings of the CUDA kernels match the kernels' C
signatures (a mismatch would otherwise show only on the card, as a cut
pointer). CPU only; no XLA."""

import ctypes
import dataclasses
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pslam_tpu_torch import interop
from pslam_tpu_torch.ops import fused_match, fused_pose
from pslam_tpu_torch.pipeline.system import SlamSystem
from pslam_tpu_torch.utils.config import SlamConfig

CSRC = Path(fused_match.__file__).resolve().parents[1] / "csrc"
CFG = SlamConfig(use_lines=False, use_bow=False, use_loop_closing=False)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default constructs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlamSystem(CFG)


def test_cpu_on_request():
    slam = SlamSystem(CFG, device="cpu")
    assert slam.device == torch.device("cpu")


def test_default_config_runs_on_the_card_or_on_request():
    """BASELINE config 4, the default ``SlamConfig()`` (BoW + loop closing),
    constructs like the other configs: on the card by default, on the CPU
    on request."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SlamSystem(SlamConfig())
    slam = SlamSystem(SlamConfig(), device="cpu")
    assert slam.kf_db is not None and slam.loop_closer is not None
    assert slam.kf_db.vocab.device == torch.device("cpu")


def test_distributed_system_runs_on_the_card_or_on_request():
    """``distributed=True`` constructs like the other configs: on the card
    by default, on the CPU on request."""
    cfg = dataclasses.replace(CFG, distributed=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SlamSystem(cfg)
    assert SlamSystem(cfg, device="cpu").device == torch.device("cpu")


def test_app_runs_on_the_card_or_on_request(tmp_path, monkeypatch):
    """``apps.rgbd_tum`` tracks on the card by default and on the CPU with
    ``--device cpu``, here on one rendered 640x480 frame."""
    from PIL import Image

    from pslam_tpu_torch.apps.rgbd_tum import main
    from pslam_tpu_torch.io.synthetic import render_sequence

    gray, depth, _ = render_sequence(CFG.camera, n_frames=1, seed=0)
    Image.fromarray(np.clip(gray[0], 0, 255).astype(np.uint8)).save(tmp_path / "rgb.png")
    Image.fromarray(np.clip(depth[0] * 5000, 0, 65535).astype(np.uint16)).save(
        tmp_path / "depth.png")
    (tmp_path / "assoc.txt").write_text("0.0 rgb.png 0.0 depth.png\n")
    (tmp_path / "settings.yaml").write_text("Camera.fx: 517.306408\n")
    args = [str(tmp_path / "settings.yaml"), str(tmp_path), str(tmp_path / "assoc.txt"),
            "one", "--no-lines", "--no-loop"]
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
    assert main(args + ["--device", "cpu"]) == 0
    assert (tmp_path / "f_one.txt").read_text().count("\n") == 1


CONVERTERS = sorted(
    name for name, fn in vars(interop).items()
    if name.endswith("_from_numpy") and "device" in inspect.signature(fn).parameters
)


@pytest.mark.parametrize("name", CONVERTERS)
def test_converters_default_to_the_card(name):
    assert inspect.signature(getattr(interop, name)).parameters["device"].default == "cuda"


def test_every_device_converter_is_held():
    assert len(CONVERTERS) == 9


def _c_argtypes(src: Path) -> dict:
    """Each ``extern "C" int`` function of a .cu file -> its argtypes as
    ctypes declares them: a pointer is ``c_void_p``, an ``int`` is
    ``c_int``."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
        types = []
        for p in (" ".join(p.split()) for p in params.split(",")):
            if "*" in p:
                types.append(ctypes.c_void_p)
            elif p.startswith("int "):
                types.append(ctypes.c_int)
            else:
                raise AssertionError(f"{src.name}: {name} has a parameter {p!r}")
        out[name] = types
    return out


@pytest.mark.parametrize("module", [fused_match, fused_pose], ids=["fused_match", "fused_pose"])
def test_ctypes_bindings_match_the_c_signatures(module):
    src = CSRC / (module.__name__.rsplit(".", 1)[1] + ".cu")
    c_side = _c_argtypes(src)
    assert c_side, f"no extern \"C\" function found in {src.name}"
    assert c_side == module.ARGTYPES
