"""TUM RGB-D / ICL-NUIM dataset IO (port of ``pslam_tpu/io/tum.py``).

Replaces the reference's dataset plumbing: the association-file loader
(rgbd_tum.cc:180-208 ``LoadImages``), the per-frame image decode + depth
scaling (Tracking.cc:214-272 ``GrabImageRGBD``: BGR->gray convert,
``depth *= 1/DepthMapFactor``), and the OpenCV-YAML settings reader
(Tracking.cc:53-154). No OpenCV and no PIL: PNGs decode with zlib and numpy
(``_read_png``, the subset TUM and ICL use), and the settings files are the
reference's simple flat ``key: value`` YAML dialect.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import numpy as np

from pslam_tpu_torch.geometry import Camera
from pslam_tpu_torch.utils.config import SlamConfig


def load_associations(path: str):
    """Parse a TUM association file: ``t_rgb rgb_rel t_depth depth_rel``
    per line, '#' comments skipped (rgbd_tum.cc:180-208)."""
    ts, rgb, dts, dep = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts.append(float(parts[0]))
            rgb.append(parts[1])
            dts.append(float(parts[2]))
            dep.append(parts[3])
    return ts, rgb, dts, dep


def load_settings_yaml(path: str) -> dict:
    """Read the reference's flat OpenCV-YAML settings dialect
    (Examples/RGB-D/TUM1.yaml): ``Key.Sub: value`` scalars only."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip()
            if not val:
                continue
            try:
                out[key] = float(val) if ("." in val or "e" in val) else int(val)
            except ValueError:
                out[key] = val.strip('"')
    return out


def config_from_settings(settings: dict, base: SlamConfig | None = None) -> SlamConfig:
    """Build a SlamConfig from reference-style settings keys
    (Camera.fx/.fy/.cx/.cy/.bf, ORBextractor.nFeatures/.scaleFactor/.nLevels/
    .iniThFAST/.minThFAST, ThDepth, DepthMapFactor; Tracking.cc:53-154)."""
    base = base or SlamConfig()
    cam = Camera(
        fx=float(settings.get("Camera.fx", base.camera.fx)),
        fy=float(settings.get("Camera.fy", base.camera.fy)),
        cx=float(settings.get("Camera.cx", base.camera.cx)),
        cy=float(settings.get("Camera.cy", base.camera.cy)),
        bf=float(settings.get("Camera.bf", base.camera.bf)),
        width=int(settings.get("Camera.width", base.camera.width)),
        height=int(settings.get("Camera.height", base.camera.height)),
        k1=float(settings.get("Camera.k1", 0.0)),
        k2=float(settings.get("Camera.k2", 0.0)),
        p1=float(settings.get("Camera.p1", 0.0)),
        p2=float(settings.get("Camera.p2", 0.0)),
        k3=float(settings.get("Camera.k3", 0.0)),
    )
    orb = dataclasses.replace(
        base.orb,
        n_features=int(settings.get("ORBextractor.nFeatures", base.orb.n_features)),
        scale=float(settings.get("ORBextractor.scaleFactor", base.orb.scale)),
        levels=int(settings.get("ORBextractor.nLevels", base.orb.levels)),
        th_fast_hi=int(settings.get("ORBextractor.iniThFAST", base.orb.th_fast_hi)),
        th_fast_lo=int(settings.get("ORBextractor.minThFAST", base.orb.th_fast_lo)),
    )
    fps = float(settings.get("Camera.fps", 30.0))
    tracking = dataclasses.replace(
        base.tracking,
        th_depth_factor=float(settings.get("ThDepth", base.tracking.th_depth_factor)),
        kf_max_interval=int(fps) if fps > 0 else base.tracking.kf_max_interval,
    )
    return dataclasses.replace(base, camera=cam, orb=orb, tracking=tracking)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> samples per pixel: 8-bit gray, RGB and RGBA and
# 16-bit gray, what TUM and ICL PNGs use.
_PNG_FORMATS = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}


def _png_chunks(buf: bytes):
    """(type, data) of every chunk, CRCs checked."""
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError("truncated PNG chunk")
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if len(data) != length or zlib.crc32(kind + data) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _unfilter_band(rec, filt, sel, a: int, b: int, W: int):
    """Reconstruct rows [a, b) of any filter types along anti-diagonals.

    Sub, Average and Paeth read the reconstructed pixel to the left and Up,
    Average and Paeth the one above, so pixel (y, x) depends only on pixels
    of smaller y + x: step d = y + x handles every pixel of one diagonal,
    each with its row's filter. In the (H + 1, W + 1) zero-padded layout of
    ``rec`` and ``filt`` the pixels of a diagonal and their left, upper and
    upper-left neighbours are strided slices (stride W)."""
    avg, paeth = sel[a:b, 3].any(), sel[a:b, 4].any()
    for d in range(a, b + W - 1):
        y0, y1 = max(a, d - W + 1), min(b, d + 1)
        o, e = y0 * W + d, y1 * W + d
        left = rec[o + W + 1:e + W + 1:W]
        up = rec[o + 1:e + 1:W]
        s = sel[y0:y1, :, None]
        pred = np.where(s[:, 1], left, np.where(s[:, 2], up, 0))
        if avg:
            pred = np.where(s[:, 3], (left + up) >> 1, pred)
        if paeth:
            ul = rec[o:e:W]
            pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
            pred = np.where(s[:, 4], np.where((pa <= pb) & (pa <= pc), left,
                                              np.where(pb <= pc, up, ul)), pred)
        cur = slice(o + W + 2, e + W + 2, W)
        rec[cur] = (filt[cur] + pred) & 255


def _png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (H, 1 + W * bpp) scanlines -> (H, W, bpp)
    uint8.

    None, Sub and Up rows are reconstructed a row at a time (Sub as a
    cumulative sum mod 256); runs of Average and Paeth rows, whose bytes
    depend on the reconstructed byte to their left, along anti-diagonals
    (``_unfilter_band``), L + W - 1 steps for a run of L rows. Where the runs
    would cost more steps than one band over the whole image (H + W - 1),
    the whole image is one band."""
    H = raw.shape[0]
    ft = raw[:, 0]
    if np.any(ft > 4):
        raise ValueError(f"PNG row filter type {int(ft.max())} is not 0-4")
    W = (raw.shape[1] - 1) // bpp
    padded = np.zeros((H + 1, W + 1, bpp), np.int16)
    padded[1:, 1:] = raw[:, 1:].reshape(H, W, bpp)
    filt = padded.reshape(-1, bpp)
    rec = np.zeros_like(filt)
    rows = rec.reshape(H + 1, W + 1, bpp)
    sel = np.zeros((H, 5), bool)
    sel[np.arange(H), ft] = True
    hard = ft >= 3
    starts = np.flatnonzero(hard & ~np.r_[False, hard[:-1]])
    ends = np.flatnonzero(hard & ~np.r_[hard[1:], False]) + 1
    if (H - hard.sum()) + np.sum(ends - starts + W - 1) >= H + W - 1:
        _unfilter_band(rec, filt, sel, 0, H, W)
    else:
        run_end = dict(zip(starts.tolist(), ends.tolist()))
        y = 0
        while y < H:
            if y in run_end:
                _unfilter_band(rec, filt, sel, y, run_end[y], W)
                y = run_end[y]
                continue
            f = padded[y + 1]
            if ft[y] == 1:
                rows[y + 1, 1:] = np.cumsum(f[1:], axis=0) & 255
            elif ft[y] == 2:
                rows[y + 1] = (f + rows[y]) & 255
            else:
                rows[y + 1] = f
            y += 1
    return rows[1:, 1:].astype(np.uint8)


def _read_png(path: str) -> np.ndarray:
    """Decode a non-interlaced PNG of 8-bit gray, RGB or RGBA or 16-bit gray:
    (H, W) uint8 or uint16, or (H, W, 3|4) uint8. Any other PNG (palette,
    gray + alpha, bit depths other than 8 and 16 gray, Adam7) and any
    corrupt file raise ``ValueError``."""
    with open(path, "rb") as f:
        buf = f.read()
    header, idat = None, []
    for kind, data in _png_chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, compression, filter_method, interlace = header
    channels = _PNG_FORMATS.get((colour, depth))
    if channels is None:
        raise ValueError(f"{path}: PNG colour type {colour} at bit depth {depth} is not "
                         "supported (8-bit gray, RGB, RGBA or 16-bit gray only)")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as err:
        raise ValueError(f"{path}: corrupt PNG image data: {err}") from None
    bpp = channels * depth // 8
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"{path}: PNG image data has {len(raw)} bytes, expected "
                         f"{h * (1 + w * bpp)}")
    px = _png_unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        return px.reshape(h, w * 2).view(">u2").astype(np.uint16)
    return px[..., 0] if channels == 1 else px


def load_rgb_gray(path: str) -> np.ndarray:
    """Decode an RGB(A)/gray PNG to float32 grayscale, reference weights
    (cvtColor RGB2GRAY, Tracking.cc:226-238)."""
    a = _read_png(path)
    if a.ndim == 3:
        a = (
            0.299 * a[..., 0].astype(np.float32)
            + 0.587 * a[..., 1].astype(np.float32)
            + 0.114 * a[..., 2].astype(np.float32)
        )
    return np.ascontiguousarray(a, np.float32)


def load_depth(path: str, depth_map_factor: float = 5000.0) -> np.ndarray:
    """Decode a 16-bit depth PNG to float32 meters (Tracking.cc:265-268:
    ``imD.convertTo(imD, CV_32F, 1/DepthMapFactor)``)."""
    a = _read_png(path).astype(np.float32)
    if depth_map_factor > 0:
        a = a / np.float32(depth_map_factor)
    return np.ascontiguousarray(a)


@dataclasses.dataclass
class TumRgbdDataset:
    """Sequence of (gray float32 HxW, depth-in-meters float32 HxW, timestamp).

    seq_dir:     dataset root containing rgb/ and depth/
    assoc_path:  association file of (t_rgb rgb t_d depth) rows
    """

    seq_dir: str
    assoc_path: str
    depth_map_factor: float = 5000.0

    def __post_init__(self):
        self.timestamps, self._rgb, _, self._depth = load_associations(self.assoc_path)

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i: int):
        gray = load_rgb_gray(os.path.join(self.seq_dir, self._rgb[i]))
        depth = load_depth(os.path.join(self.seq_dir, self._depth[i]), self.depth_map_factor)
        return gray, depth, self.timestamps[i]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
