"""The port's entry point runs on the card unless the caller asks for the
CPU, and the ctypes bindings of the CUDA kernels match the kernels' C
signatures (a mismatch would otherwise show only on the card, as a cut
pointer). CPU only; no XLA."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

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
