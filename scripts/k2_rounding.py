"""Where K2's chi2 rounding comes from, on one NVIDIA GPU.

    python3 scripts/k2_rounding.py

Builds ``pslam_tpu_torch/csrc/fused_pose.cu`` four ways into
``build/k2_rounding/`` (outside the kernels' build cache): as the package
builds it, with ``--fmad=false``, and with the projection (``u``, ``v``) or
the rigid transform (``x``, ``y``, ``z``) rounded op by op
(``__fmul_rn``/``__fadd_rn``, which nvcc never contracts). Each variant and
the plain PyTorch version (``ops/fused_pose.pose_terms_plain``) run on the
inputs of ``chip_smoke.py`` phase 3; a float64 run of the plain version on
float64 copies of the same inputs is the reference. For each it prints the
largest |chi2 - chi2_f64|, that deviation in ulps of the edge's pixel
coordinate (``k = |dchi2| / (2 (|r_u| + |r_v| + |r_r|) ulp(max(|u|, |v|,
|ur|)) inv_sigma2)``), the edges beyond the 1e-4 chi2 bar against the plain
version, and the variant's time per call (median of 200 launches between
CUDA events). The last line is one JSON object with those numbers.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RN_PROJ = (
    ("const float u = fx * x * iz + cx;",
     "const float u = __fadd_rn(__fmul_rn(__fmul_rn(fx, x), iz), cx);"),
    ("const float v = fy * y * iz + cy;",
     "const float v = __fadd_rn(__fmul_rn(__fmul_rn(fy, y), iz), cy);"),
)
RN_XFORM = tuple(
    (f"const float {c} = R{i}0 * X0 + R{i}1 * X1 + R{i}2 * X2 + t{i};",
     f"const float {c} = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(R{i}0, X0), "
     f"__fmul_rn(R{i}1, X1)), __fmul_rn(R{i}2, X2)), t{i});")
    for i, c in enumerate("xyz")
)


def _variant(name, subs, extra_flags, out_dir):
    from pslam_tpu_torch.ops import _build, fused_pose

    src = (_build.CSRC / "fused_pose.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise AssertionError(f"{name}: expression not found in fused_pose.cu: {old}")
        src = src.replace(old, new)
    cu = out_dir / f"fused_pose_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"libfused_pose_{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra_flags, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    fn = ctypes.CDLL(str(so)).pslam_fused_pose
    fn.argtypes = fused_pose.ARGTYPES["pslam_fused_pose"]
    fn.restype = ctypes.c_int
    return fn


def _launcher(fn):
    from pslam_tpu_torch.ops import _build

    def run(data, par):
        E = data.shape[1]
        out = [torch.empty(s, dtype=torch.float32, device=data.device)
               for s in ((6, 6), (6,), (1,), (E,))]
        rc = fn(data.data_ptr(), par.data_ptr(), E, *(o.data_ptr() for o in out),
                _build.stream_ptr(data))
        if rc != 0:
            raise RuntimeError(f"K2 variant launch failed: CUDA error {rc}")
        return out[0], out[1], out[2][0], out[3]
    return run


def _f64_reference(data, par):
    """chi2, r (E, 3) and the projected [u, v, ur] in float64."""
    from pslam_tpu_torch.geometry import Camera
    from pslam_tpu_torch.ops.fused_pose import pose_terms_plain
    from pslam_tpu_torch.solver.reproj import stereo_residual_jac

    d64, p64 = data.double(), par.double()
    chi2 = pose_terms_plain(d64, p64)[3]
    p = p64.reshape(-1)
    fx, fy, cx, cy, bf = p[16:21].tolist()
    cam = Camera(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf)
    obs = d64[3:6].T
    r = stereo_residual_jac(cam, p[:16].reshape(1, 4, 4), d64[0:3].T, obs)[0]
    r = r * torch.stack([torch.ones_like(obs[:, 0]), torch.ones_like(obs[:, 0]),
                         (obs[:, 2] >= 0).double()], dim=-1)
    return chi2, r, obs - r


def _median_ms(fn, runs=200, warmup=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main():
    import chip_smoke as cs

    cs._identity()
    import pslam_tpu_torch  # noqa: F401  (turns TF32 off)
    from pslam_tpu_torch.geometry import Camera
    from pslam_tpu_torch.ops import fused_pose

    dev = torch.device("cuda", 0)
    out_dir = ROOT / "build" / "k2_rounding"
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = {"built": ((), []), "fmad_false": ((), ["--fmad=false"]),
             "rn_projection": (RN_PROJ, []), "rn_transform": (RN_XFORM, [])}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as pool:
        futs = {n: pool.submit(_variant, n, s, f, out_dir) for n, (s, f) in specs.items()}
        kernels = {n: _launcher(f.result()) for n, f in futs.items()}
    print(f"[k2 rounding] {len(kernels)} variants built in {time.perf_counter() - t0:.1f} s")

    cam = Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)
    cases = {"all mono at the truth": dict(seed=4, mono=True),
             "all mono off the truth": dict(seed=4, mono=True, off_truth=True),
             "30% mono at the truth": dict(seed=0)}
    report = {}
    for label, kw in cases.items():
        data, T = cs._pose_inputs(fused_pose, dev, 4096, kw["seed"], cam,
                                  off_truth=kw.get("off_truth", False),
                                  mono=kw.get("mono", False))
        par = fused_pose.pack_pose_params(T, fused_pose.pose_param_tail(cam, True, dev))
        chi2_64, r64, proj64 = _f64_reference(data, par)
        chi2_64, r64, proj64 = (t.cpu().numpy() for t in (chi2_64, r64, proj64))
        inv_s2 = data[6].double().cpu().numpy()
        coord = np.abs(proj64).max(axis=1).astype(np.float32)
        ulp = np.spacing(coord).astype(np.float64)
        denom = 2.0 * np.abs(r64).sum(axis=1) * ulp * inv_s2
        outs = {n: k(data, par)[3] for n, k in kernels.items()}
        outs["plain f32"] = fused_pose.pose_terms_plain(data, par)[3]
        plain = outs["plain f32"].double().cpu().numpy()
        bar = 1e-4 + 1e-4 * np.abs(plain)
        row = {}
        for name, chi2 in outs.items():
            c = chi2.double().cpu().numpy()
            dev64 = np.abs(c - chi2_64)
            k = dev64 / np.maximum(denom, 1e-300)
            row[name] = dict(max_abs_dev_f64=float(dev64.max()), max_k_ulp=float(k.max()),
                             beyond_bar_vs_plain=int((np.abs(c - plain) > bar).sum()),
                             max_abs_diff_vs_plain=float(np.abs(c - plain).max()))
            print(f"[k2 rounding] {label}: {name:>14}: max |chi2 - f64| "
                  f"{row[name]['max_abs_dev_f64']:.3e}, max k {row[name]['max_k_ulp']:.2f} ulp; "
                  f"vs plain: {row[name]['beyond_bar_vs_plain']} of 4096 beyond the 1e-4 bar, "
                  f"max |diff| {row[name]['max_abs_diff_vs_plain']:.3e}")
        report[label] = row
    data, T = cs._pose_inputs(fused_pose, dev, 4096, 4, cam, mono=True)
    par = fused_pose.pack_pose_params(T, fused_pose.pose_param_tail(cam, True, dev))
    times = {n: [] for n in kernels}
    for _ in range(2):  # in turns: built, variants, variants reversed
        for n in list(kernels) + list(kernels)[::-1]:
            times[n].append(_median_ms(lambda: kernels[n](data, par)))
    times = {n: float(np.median(v)) for n, v in times.items()}
    device_ms = {n: cs._device_ms(lambda: kernels[n](data, par), runs=200) for n in kernels}
    print("[k2 rounding] ms per call (median of 200 launches, median over 4 turns): "
          + ", ".join(f"{n} {v:.4f}" for n, v in times.items())
          + "; device ms per call (torch.profiler, 200 calls): "
          + ", ".join(f"{n} {cs._fmt_ms(v)}" for n, v in device_ms.items()))
    print(json.dumps({"k2_rounding": report, "ms": times, "device_ms": device_ms,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    sys.exit(main())
