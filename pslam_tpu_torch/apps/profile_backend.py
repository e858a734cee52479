"""Per-stage cost of the keyframe-rate backend on the card: the counterpart
of ``scripts/profile_backend.py`` plus ``scripts/bench_sharded.py``.

From ``profile_backend.py``, on its random local-BA problem
(``default_rng(0)``, ``caps.ba_cams`` cameras, ``caps.ba_points`` points,
``caps.ba_edges`` = 16384 edges, ``caps.ba_free`` free): ``edge_terms``,
``assemble``, ``solve_schur`` (the port's ``_schur_landmarks`` +
``_schur_cameras`` + ``_back_substitute``, each also a row of its own),
``full BA (5+10 LM)``, ``epipolar_triangulate`` on two random keyframe
views, ``bare gather (1000 rows of 3)`` and ``hamming+mutualNN
(1000x1000)``.

From ``bench_sharded.py``, plain against sharded at one rank: the local BA
at 48 cams / 2048 points / 8192 edges, the LIL BA with Q = 64 and
``caps.ba_lil_edges`` edges, and the essential graph at 128 keyframes /
256 edges with 20 iterations. "Sharded" runs the solvers over ``Ranks`` of
a one-rank process group (NCCL on the card, gloo on the CPU), which this
app starts unless ``torch.distributed`` already runs; each sharded row
gives ``max|dT|`` against the plain result.

Each row is ``utils.profile``'s. The table goes to stdout and to ``--out
PATH``. Runs on the CUDA card unless ``--device cpu`` asks for host times on
the CPU.

Usage:
    python -m pslam_tpu_torch.apps.profile_backend [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import socket
import sys

import numpy as np
import torch

REPS = 10  # scripts/profile_backend.py's R, a ceiling
BA_REPS = 3  # its full-BA timing loop
GRAPH_REPS = 3  # scripts/bench_sharded.py's essential-graph R, a ceiling
# scripts/bench_sharded.py: points, edges, LILs, graph keyframes and edges.
SHARDED_SHAPE = (2048, 8192, 64, 128, 256)


def _observe(cam, T, X):
    """Stereo pixels [u, v, ur] (E, 3) of points ``X`` (E, 3) seen from
    ``T`` (E, 4, 4), in numpy f32 rounded as the JAX scripts' XLA CPU program
    rounds them (a rotation row: one product, then two fused multiply-adds,
    then the translation; ``fx * x / z + cx``), so that both packages
    profile bit-identical inputs."""
    R, t = T[:, :3, :3].astype(np.float64), T[:, :3, 3]
    Xd = X.astype(np.float64)
    acc = (R[..., 0] * Xd[:, None, 0]).astype(np.float32)
    for k in (1, 2):
        acc = (R[..., k] * Xd[:, None, k] + acc).astype(np.float32)
    Xc = acc + t
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    z = np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    u = np.float32(cam.fx) * x / z + np.float32(cam.cx)
    v = np.float32(cam.fy) * y / z + np.float32(cam.cy)
    return np.stack([u, v, u - np.float32(cam.bf) / z], axis=-1)


def random_ba_problem(cfg, rng, n_points: int, n_edges: int, device):
    """The random local-BA problem of ``scripts/profile_backend.py:65-92``
    (and of ``bench_sharded.py`` and ``roofline.py`` at 2048 points and 8192
    edges), drawing from ``rng`` in the script's order. Returns (BAProblem
    on ``device``, obs (E, 3), T_cw (C, 4, 4)) with the last two in numpy."""
    from pslam_tpu_torch.geometry import se3_exp
    from pslam_tpu_torch.solver.local_ba import BAProblem

    cam, caps = cfg.camera, cfg.caps
    C, P, E, n_free = caps.ba_cams, n_points, n_edges, caps.ba_free
    X = rng.uniform([-3, -2, 1], [3, 2, 8], (P, 3)).astype(np.float32)
    T_cw = np.stack([
        se3_exp(torch.from_numpy(
            np.r_[rng.normal(0, 0.01, 3), 0.05 * c, 0, 0].astype(np.float32))).numpy()
        for c in range(C)
    ])
    cam_idx = rng.integers(0, C, E).astype(np.int32)
    pt_idx = rng.integers(0, P, E).astype(np.int32)
    obs = _observe(cam, T_cw[cam_idx], X[pt_idx]) + rng.normal(0, 0.3, (E, 3)).astype(np.float32)
    free_slot = np.full(C, -1, np.int32)
    free_slot[1: 1 + n_free] = np.arange(n_free)
    X_w = X + rng.normal(0, 0.02, X.shape).astype(np.float32)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    prob = BAProblem(
        T_cw=t(T_cw.astype(np.float32)), free_slot=t(free_slot, torch.int64), X_w=t(X_w),
        point_valid=torch.ones(P, dtype=torch.bool, device=device),
        cam_idx=t(cam_idx, torch.int64), pt_idx=t(pt_idx, torch.int64),
        obs=t(obs.astype(np.float32)),
        inv_sigma2=torch.ones(E, dtype=torch.float32, device=device),
        edge_valid=torch.ones(E, dtype=torch.bool, device=device))
    return prob, obs, T_cw


def random_views(cfg, rng, obs, T_cw, device):
    """The two ``KFView``s of ``scripts/profile_backend.py:134-147``, then
    the bare gather's index and values (``:153-154``), drawing from ``rng``
    in the script's order."""
    from pslam_tpu_torch.ops.triangulate import KFView

    N, E = cfg.orb.capacity, obs.shape[0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def view(c):
        return KFView(
            T_cw=t(T_cw[c].astype(np.float32)),
            uv=t(obs[rng.integers(0, E, N), :2].astype(np.float32)),
            ur=t(np.full(N, -1, np.float32)),
            depth=t(rng.uniform(1, 5, N).astype(np.float32)),
            level=torch.zeros(N, dtype=torch.int32, device=device),
            angle=torch.zeros(N, dtype=torch.float32, device=device),
            desc=t(rng.integers(0, 256, (N, 32), dtype=np.uint8)),
            free=torch.ones(N, dtype=torch.bool, device=device))

    v1, v2 = view(0), view(1)
    j = t(rng.integers(0, N, N).astype(np.int64))
    vals = t(rng.normal(size=(N, 3)).astype(np.float32))
    return v1, v2, j, vals


def random_lil_problem(cfg, rng, device, Q: int = 64):
    """The LIL BA inputs of ``scripts/bench_sharded.py:121-132``: (lil_state
    (Q, 15), lil_valid (Q,), LILBAEdges of ``caps.ba_lil_edges``)."""
    from pslam_tpu_torch.solver.ba_lil import LILBAEdges

    C, El = cfg.caps.ba_cams, cfg.caps.ba_lil_edges
    lil_state = np.concatenate(
        [rng.uniform([-3, -2, 1], [3, 2, 8], (Q, 3)).astype(np.float32)] * 5, axis=1)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    ledges = LILBAEdges(
        cam_idx=t(rng.integers(0, C, El).astype(np.int32), torch.int64),
        lil_idx=t(rng.integers(0, Q, El).astype(np.int32), torch.int64),
        obs=t(rng.normal(0, 1, (El, 8)).astype(np.float32)),
        valid=torch.ones(El, dtype=torch.bool, device=device))
    return t(lil_state), torch.ones(Q, dtype=torch.bool, device=device), ledges


def random_pose_graph(rng, device, K: int = 128, Eg: int = 256):
    """The essential graph of ``scripts/bench_sharded.py:145-167``: a ring of
    ``K`` keyframes with noisy centres and ``Eg`` edges, vertex 0 fixed."""
    from pslam_tpu_torch.geometry.lie import Sim3
    from pslam_tpu_torch.solver.sim3_graph import PoseGraphProblem

    angles = 2 * np.pi * np.arange(K) / K
    Rk = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    tk = np.stack([np.cos(angles), np.zeros(K), np.sin(angles)], -1).astype(np.float32)
    tk += rng.normal(0, 0.02, tk.shape).astype(np.float32)
    e_i = np.r_[np.arange(K - 1), rng.integers(0, K, Eg - (K - 1))].astype(np.int32)
    e_j = np.r_[np.arange(1, K), rng.integers(0, K, Eg - (K - 1))].astype(np.int32)
    e_j = np.where(e_j == e_i, (e_j + 1) % K, e_j).astype(np.int32)
    fixed = np.zeros(K, bool)
    fixed[0] = True

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return PoseGraphProblem(
        S=Sim3(s=torch.ones(K, device=device), R=t(Rk), t=t(tk)), fixed=t(fixed),
        vertex_valid=torch.ones(K, dtype=torch.bool, device=device),
        e_i=t(e_i, torch.int64), e_j=t(e_j, torch.int64),
        e_Sji=Sim3(s=torch.ones(Eg, device=device),
                   R=t(np.tile(np.eye(3, dtype=np.float32), (Eg, 1, 1))),
                   t=torch.zeros((Eg, 3), device=device)),
        e_valid=torch.ones(Eg, dtype=torch.bool, device=device))


def ba_count(prob, n_free: int) -> int:
    """``utils.profile.ba_ops`` of one problem."""
    from pslam_tpu_torch.utils import profile as P

    k = P.cams_per_point(prob.free_slot, prob.cam_idx, prob.pt_idx, prob.edge_valid,
                         prob.X_w.shape[0])
    return P.ba_ops(prob.cam_idx.shape[0], k.cpu(), n_free)


def internals_rows(cfg, device, reps: int = REPS, ba_reps: int = BA_REPS) -> list[dict]:
    """The rows of ``scripts/profile_backend.py``."""
    from pslam_tpu_torch.ops.match import hamming_matrix, mutual_nn_match
    from pslam_tpu_torch.ops.triangulate import epipolar_triangulate
    from pslam_tpu_torch.solver.local_ba import (ONE_DEVICE, _assemble, _back_substitute,
                                                 _edge_terms, _problem_plan, _schur_cameras,
                                                 _schur_landmarks, _schur_step,
                                                 local_bundle_adjustment)
    from pslam_tpu_torch.utils import profile as P

    cam, n_free = cfg.camera, cfg.caps.ba_free
    rng = np.random.default_rng(0)
    prob, obs, T_cw = random_ba_problem(cfg, rng, cfg.caps.ba_points, cfg.caps.ba_edges, device)
    E = prob.cam_idx.shape[0]
    k = P.cams_per_point(prob.free_slot, prob.cam_idx, prob.pt_idx, prob.edge_valid,
                         prob.X_w.shape[0]).cpu()

    def terms(T_all, X_all):
        return _edge_terms(cam, prob, T_all, X_all, prob.edge_valid, True)

    _, w_eff, r, Jc, Jp, _ = terms(prob.T_cw, prob.X_w)
    plan = _problem_plan(prob, n_free)
    blocks = _assemble(plan, n_free, w_eff, r, Jc, Jp)
    Hcc, bc, Hpp, bp, G = blocks
    lam = torch.full((), 1e-4, dtype=torch.float32, device=device)
    Hpp_inv, S_red, b_sub = _schur_landmarks(Hpp, bp, G, prob.point_valid, lam)
    dx_c = _schur_cameras(Hcc, bc, S_red, b_sub, lam)
    v1, v2, j, vals = random_views(cfg, rng, obs, T_cw, device)
    N = v1.uv.shape[0]
    land, cams, back = (P.schur_landmark_ops(k), P.schur_camera_ops(n_free),
                        P.back_substitute_ops(k))
    rows = [
        P.stage_row(f"edge_terms ({E} e)", terms, prob.T_cw, prob.X_w,
                    ops=E * P.BA_TERM_EDGE_OPS, reps=reps, device=device),
        P.stage_row("assemble", lambda *a: _assemble(plan, n_free, *a), w_eff, r, Jc, Jp,
                    ops=E * P.BA_ASSEMBLE_EDGE_OPS, reps=reps, device=device),
        P.stage_row("solve_schur", lambda *b: _schur_step(ONE_DEVICE, b, prob.point_valid, lam),
                    *blocks, ops=land + cams + back, reps=reps, device=device),
        P.stage_row("  _schur_landmarks", lambda *a: _schur_landmarks(*a, prob.point_valid, lam),
                    Hpp, bp, G, ops=land, reps=reps, device=device),
        P.stage_row("  _schur_cameras", lambda *a: _schur_cameras(*a, lam),
                    Hcc, bc, S_red, b_sub, ops=cams, reps=reps, device=device),
        P.stage_row("  _back_substitute", lambda *a: _back_substitute(*a, prob.point_valid, dx_c),
                    Hpp_inv, bp, G, ops=back, reps=reps, device=device),
        P.stage_row("full BA (5+10 LM)", lambda p: local_bundle_adjustment(cam, p, n_free),
                    prob, ops=P.ba_ops(E, k, n_free), reps=ba_reps, warmup=1, prof_reps=1,
                    device=device),
        P.stage_row("epipolar_triangulate", lambda a, b: epipolar_triangulate(cam, a, b, 1.2, 8),
                    v1, v2, reps=reps, device=device),
        P.stage_row(f"bare gather ({N} rows of 3)", lambda v, jj: v[jj], vals, j, ops=0,
                    reps=reps, device=device),
        P.stage_row(f"hamming+mutualNN ({N}x{N})", lambda a, b: mutual_nn_match(
            hamming_matrix(a.desc, b.desc), valid_a=a.free, valid_b=b.free, max_dist=50,
            ratio=1.0), v1, v2, ops=P.HAMMING_PAIR_OPS * N * N, reps=reps, device=device),
    ]
    return rows


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(device):
    """A one-rank ``torch.distributed`` group for the sharded solvers (NCCL
    on the card, gloo on the CPU), unless one already runs."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _pose(out):
    """The poses of a solver's result: a BA's T_opt, the graph's Sim3s."""
    return out if hasattr(out, "R") else out[0]


def _max_diff(a, b) -> float:
    if isinstance(a, torch.Tensor):
        return float((a.double() - b.double()).abs().max())
    return max(_max_diff(x, y) for x, y in zip(a, b))


def sharded_rows(cfg, device, reps: int = BA_REPS, graph_reps: int = GRAPH_REPS,
                 shape=SHARDED_SHAPE) -> list[dict]:
    """The plain and one-rank sharded rows of ``scripts/bench_sharded.py``;
    ``shape`` = (points, edges, LILs, graph keyframes, graph edges)."""
    from pslam_tpu_torch.parallel.sharded_ba import (sharded_local_bundle_adjustment,
                                                     sharded_local_bundle_adjustment_lil)
    from pslam_tpu_torch.parallel.sharded_graph import optimize_essential_graph_sharded
    from pslam_tpu_torch.solver.ba_lil import local_bundle_adjustment_lil
    from pslam_tpu_torch.solver.local_ba import local_bundle_adjustment
    from pslam_tpu_torch.solver.sim3_graph import optimize_essential_graph
    from pslam_tpu_torch.utils import profile as P

    cam, n_free = cfg.camera, cfg.caps.ba_free
    rng = np.random.default_rng(0)
    n_pts, n_e, Q, K, Eg = shape
    prob, _, _ = random_ba_problem(cfg, rng, n_pts, n_e, device)
    lil_state, lil_valid, ledges = random_lil_problem(cfg, rng, device, Q)
    graph = random_pose_graph(rng, device, K, Eg)
    El = ledges.cam_idx.shape[0]
    cases = [
        (f"local BA ({prob.T_cw.shape[0]}c/{n_pts}p/{n_e}e)", ba_count(prob, n_free), reps,
         lambda: local_bundle_adjustment(cam, prob, n_free),
         lambda: sharded_local_bundle_adjustment(cam, prob, n_free)),
        (f"LIL BA (Q={Q}, {El} LIL e)", None, reps,
         lambda: local_bundle_adjustment_lil(cam, prob, lil_state, lil_valid, ledges, n_free),
         lambda: sharded_local_bundle_adjustment_lil(cam, prob, lil_state, lil_valid, ledges,
                                                     n_free)),
        (f"essential graph ({K} kf/{Eg} e, 20 it)", None, graph_reps,
         lambda: optimize_essential_graph(graph, n_iters=20),
         lambda: optimize_essential_graph_sharded(graph, n_iters=20)),
    ]
    rows = []
    with one_rank_group(device):
        for name, ops, n, plain, sharded in cases:
            d = _max_diff(_pose(sharded()), _pose(plain()))  # the warm-up calls
            rows.append(P.stage_row(f"{name} plain", plain, ops=ops, reps=n, warmup=0,
                                    prof_reps=1, device=device))
            rows.append(P.stage_row(f"{name} sharded, 1 rank", sharded, ops=ops, reps=n,
                                    warmup=0, prof_reps=1, device=device, max_dT=d))
    return rows


def run(device: str = "cuda", cfg=None, reps: int = REPS, ba_reps: int = BA_REPS,
        graph_reps: int = GRAPH_REPS, sharded_shape=SHARDED_SHAPE) -> list[dict]:
    """The internals' rows, then the plain and sharded rows. ``cfg``
    defaults to ``SlamConfig()``; smaller capacities are for tests on the
    CPU."""
    from pslam_tpu_torch.utils import profile as P
    from pslam_tpu_torch.utils.config import SlamConfig

    dev = P.cuda_device(device)
    cfg = cfg or SlamConfig()
    return (internals_rows(cfg, dev, reps, ba_reps)
            + sharded_rows(cfg, dev, ba_reps, graph_reps, sharded_shape))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="also write the markdown table to this path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure (default: the CUDA card)")
    args = ap.parse_args(argv)
    from pslam_tpu_torch.utils import profile as P

    rows = run(args.device)
    text = P.table(rows, "Keyframe-rate backend, a stage a row "
                   "(pslam_tpu_torch.apps.profile_backend)", args.device)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
