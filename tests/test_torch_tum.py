"""The port's TUM IO and ``apps.rgbd_tum`` against the JAX package's, on the
CPU.

- Settings, associations and ``config_from_settings``: equal to JAX's, field
  by field, on tests/test_tum_io.py's SETTINGS (exact).
- ``_read_png`` (zlib + numpy, no PIL) byte for byte equal to PIL's decode of
  8-bit gray, RGB and RGBA and 16-bit gray PNGs. Pillow's encoder filters
  rows with None, Sub, Up and Paeth (never Average), so those files come
  from PIL and a second set from this file's own encoder, which cycles all
  five filter types row by row; together they use all five. An Adam7, a
  palette and a corrupt PNG raise ``ValueError``.
- ``load_rgb_gray`` and ``load_depth``: equal to JAX's (exact).
- The app on ``small_dataset``, tests/test_tum_io.py's ``tiny_dataset`` cut
  to 4 distorted frames at 320x240 (the TUM1 settings with the intrinsics
  halved and 500 features), ``--no-lines --no-loop --kitti``
  (``--device cpu`` for the port), against the JAX app: the same file shapes
  and keyframe count, camera centres within 1 cm (the bound of
  tests/test_torch_slice.py), with JAX's top-k pinned and its scatter BA
  assembly as in the slice tests.
- The distorted-lens app run of tests/test_tum_io.py's
  ``test_rgbd_tum_app_distorted_ate``, through the port: ATE < 5 cm.
"""

import dataclasses
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from pslam_tpu.io import tum as jtum
from pslam_tpu.io.synthetic import render_sequence
from pslam_tpu_torch.io import tum as ttum
from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions
from test_tum_io import SETTINGS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings_file(tmp_path, settings=SETTINGS):
    p = tmp_path / "settings.yaml"
    p.write_text(settings)
    return str(p)


def _write_dataset(root, settings_path, n, seed):
    """``n`` frames over the arc rendered through the settings' distorted
    lens, written as a TUM-layout dataset by PIL; returns the true poses."""
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    cam = jtum.config_from_settings(jtum.load_settings_yaml(settings_path)).camera
    grays, depths, poses_gt = render_sequence(cam, n_frames=n, seed=seed, use_distortion=True)
    rows = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = 1305031102.0 + i / 30.0
        rgb8 = np.clip(g, 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([rgb8] * 3, -1)).save(root / "rgb" / f"{i}.png")
        Image.fromarray(np.clip(d * 5000.0, 0, 65535).astype(np.uint16)).save(
            root / "depth" / f"{i}.png")
        rows.append(f"{t:.6f} rgb/{i}.png {t:.6f} depth/{i}.png")
    (root / "assoc.txt").write_text("\n".join(rows) + "\n")
    return poses_gt


def _half_size(settings):
    """The settings at 320x240: intrinsics halved, the lens kept, 500
    features."""
    out = []
    for line in settings.splitlines():
        key, _, val = line.partition(":")
        if key in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy"):
            line = f"{key}: {float(val) / 2:.6f}"
        elif key in ("Camera.width", "Camera.height"):
            line = f"{key}: {int(val) // 2}"
        elif key == "ORBextractor.nFeatures":
            line = f"{key}: 500"
        out.append(line)
    return "\n".join(out) + "\n"


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    """tests/test_tum_io.py's ``tiny_dataset`` (seed 3, the TUM1 lens) at
    320x240 and 4 frames: (root, settings path)."""
    root = tmp_path_factory.mktemp("tumseq")
    settings = _settings_file(root, _half_size(SETTINGS))
    _write_dataset(root, settings, n=4, seed=3)
    return root, settings


def test_settings_and_config_equal_jax(tmp_path):
    p = _settings_file(tmp_path)
    s = ttum.load_settings_yaml(p)
    assert s == jtum.load_settings_yaml(p)
    tc = dataclasses.asdict(ttum.config_from_settings(s))
    jc = dataclasses.asdict(jtum.config_from_settings(s))
    assert tc.keys() == jc.keys()
    for name in jc:
        assert tc[name] == jc[name], name


def test_associations_equal_jax(tmp_path):
    p = tmp_path / "assoc.txt"
    p.write_text("# comment\n1305031102.175304 rgb/1.png 1305031102.160407 depth/1.png\n\n"
                 "short line\n1305031102.211214 rgb/2.png 1305031102.226738 depth/2.png\n")
    assert ttum.load_associations(str(p)) == jtum.load_associations(str(p))


# ---------------------------------------------------------------------------
# PNG decode
# ---------------------------------------------------------------------------

# (PIL mode, samples per pixel, sample maximum, numpy dtype)
FORMATS = {"L": (1, 255, np.uint8), "RGB": (3, 255, np.uint8),
           "RGBA": (4, 255, np.uint8), "I;16": (1, 65535, np.uint16)}


def _image(mode, H=70, W=48, seed=0):
    """Rows shaped so that adaptive filtering has a use for every filter:
    zero rows, random rows, means of the left and upper pixels, copies of
    the row above, ramps and 2-D gradients."""
    ch, maxv, dtype = FORMATS[mode]
    rng = np.random.default_rng(seed)
    a = np.zeros((H, W, ch), np.int64)
    for y in range(H):
        kind = y % 7
        if kind in (1, 3):
            a[y] = rng.integers(0, maxv + 1, (W, ch))
        elif kind == 2:
            for x in range(W):
                a[y, x] = ((a[y, x - 1] if x else 0) + a[y - 1, x]) // 2
        elif kind == 4:
            a[y] = a[y - 1]
        elif kind == 5:
            a[y] = np.arange(W)[:, None] * 7 % (maxv + 1)
        elif kind == 6:
            a[y] = (np.arange(W)[:, None] * 5 + y * 3) % (maxv + 1)
    a = a.astype(dtype)
    return a[..., 0] if ch == 1 else a


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data))


def _encode_cycling_filters(arr, colour, depth):
    """A PNG whose row y is filtered with type y % 5 (None, Sub, Up,
    Average, Paeth), predictions from the unfiltered bytes."""
    H, W = arr.shape[:2]
    be = arr.astype(">u2") if depth == 16 else arr
    rows = np.frombuffer(be.tobytes(), np.uint8).reshape(H, -1).astype(np.int64)
    bpp = rows.shape[1] // W
    out = []
    for y in range(H):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.r_[np.zeros(bpp, np.int64), x[:-bpp]]
        ul = np.r_[np.zeros(bpp, np.int64), up[:-bpp]]
        pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        ft = y % 5
        pred = (0, left, up, (left + up) // 2, paeth)[ft]
        out.append(np.r_[ft, (x - pred) % 256].astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b""))


def _filter_types(path, H):
    buf = open(path, "rb").read()
    idat = b"".join(d for k, d in ttum._png_chunks(buf) if k == b"IDAT")
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, -1)[:, 0].tolist())


@pytest.mark.parametrize("mode", sorted(FORMATS))
def test_read_png_equals_pil(mode, tmp_path):
    arr = _image(mode)
    colour = {"L": 0, "RGB": 2, "RGBA": 6, "I;16": 0}[mode]
    depth = 16 if mode == "I;16" else 8
    by_pil, ours = tmp_path / "pil.png", tmp_path / "cycling.png"
    Image.fromarray(arr).save(by_pil)
    ours.write_bytes(_encode_cycling_filters(arr, colour, depth))
    used = _filter_types(by_pil, arr.shape[0]) | _filter_types(ours, arr.shape[0])
    assert used == {0, 1, 2, 3, 4}
    assert _filter_types(by_pil, arr.shape[0]) >= {0, 1, 2, 4}
    for p in (by_pil, ours):
        with Image.open(p) as im:
            ref = np.asarray(im)
        got = ttum._read_png(str(p))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, arr)


def test_read_png_refuses_adam7_palette_and_corrupt_files(tmp_path):
    gray = _image("L")
    p = tmp_path / "g.png"
    Image.fromarray(gray).save(p)
    buf = p.read_bytes()
    # The same file flagged Adam7: IHDR's last byte, CRC recomputed.
    ihdr = bytearray(buf[16:29])
    ihdr[12] = 1
    adam7 = buf[:8] + _chunk(b"IHDR", bytes(ihdr)) + buf[33:]
    palette = tmp_path / "p.png"
    Image.fromarray(gray).convert("P").save(palette)
    corrupt = bytearray(buf)
    corrupt[40] ^= 0xFF
    for name, data in (("adam7", adam7), ("palette", palette.read_bytes()),
                       ("corrupt", bytes(corrupt)), ("not a png", b"GIF89a" + buf[6:])):
        q = tmp_path / f"{name}.png"
        q.write_bytes(data)
        with pytest.raises(ValueError):
            ttum._read_png(str(q))
    lowbit = tmp_path / "bits.png"
    Image.fromarray(gray > 128).save(lowbit)  # 1-bit gray
    with pytest.raises(ValueError):
        ttum._read_png(str(lowbit))


def test_load_rgb_gray_and_depth_equal_jax(tmp_path):
    rgb, d16 = tmp_path / "rgb.png", tmp_path / "d.png"
    Image.fromarray(_image("RGB")).save(rgb)
    Image.fromarray(_image("I;16")).save(d16)
    for fn, path in ((ttum.load_rgb_gray, rgb), (ttum.load_depth, d16)):
        got = fn(str(path))
        ref = getattr(jtum, fn.__name__)(str(path))
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# The app
# ---------------------------------------------------------------------------


def _app_files(name):
    return (np.loadtxt(f"f_{name}.txt"), np.atleast_2d(np.loadtxt(f"kf_{name}.txt")),
            np.loadtxt(f"kitti_{name}.txt"))


def test_app_matches_jax_app(small_dataset, tmp_path, monkeypatch):
    from pslam_tpu.apps.rgbd_tum import main as jmain
    from pslam_tpu_torch.apps.rgbd_tum import main as tmain

    root, settings = small_dataset
    assert ttum.config_from_settings(ttum.load_settings_yaml(settings)).camera.width == 320
    args = [settings, str(root), str(root / "assoc.txt")]
    flags = ["--no-lines", "--no-loop", "--kitti"]
    monkeypatch.chdir(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "approx_max_k", lambda x, k, **kw: jax.lax.top_k(x, k))
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        assert jmain(args + ["jax"] + flags) == 0
    jax.clear_caches()
    assert tmain(args + ["port"] + flags + ["--device", "cpu"]) == 0
    (fj, kfj, kitj), (ft, kft, kitt) = _app_files("jax"), _app_files("port")
    assert ft.shape == fj.shape == (4, 8) and kitt.shape == kitj.shape == (4, 12)
    assert kft.shape == kfj.shape and kft.shape[0] >= 1
    np.testing.assert_array_equal(ft[:, 0], fj[:, 0])
    worst = np.linalg.norm(ft[:, 1:4] - fj[:, 1:4], axis=1).max()
    print(f"app vs JAX app: {len(kft)} keyframes, max centre difference {worst * 1e3:.3f} mm")
    assert worst <= 0.01, worst


def test_app_distorted_ate(tmp_path, monkeypatch):
    """tests/test_tum_io.py::test_rgbd_tum_app_distorted_ate through the
    port: 12 frames over the arc rendered through the TUM1 lens at 640x480,
    written as PNGs, decoded by the port, tracked on the CPU."""
    from pslam_tpu_torch.apps.rgbd_tum import main

    settings_path = _settings_file(tmp_path)
    cfg = ttum.config_from_settings(ttum.load_settings_yaml(settings_path))
    assert cfg.camera.has_distortion and cfg.camera.width == 640
    root = tmp_path / "seq"
    n = 12
    poses_gt = _write_dataset(root, settings_path, n=n, seed=4)
    monkeypatch.chdir(tmp_path)
    assert main([settings_path, str(root), str(root / "assoc.txt"), "dist", "--no-lines",
                 "--no-loop", "--device", "cpu"]) == 0
    f = np.loadtxt("f_dist.txt")
    assert f.shape == (n, 8)
    ate = ate_rmse(f[:, 1:4], trajectory_positions(poses_gt))
    assert ate < 0.05, f"ATE {ate:.4f} m on the distorted dataset"
