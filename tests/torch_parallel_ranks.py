"""Rank bodies for tests/test_torch_parallel.py: each runs in its own process
(``torch.multiprocessing.spawn``), joins a gloo group through a ``file://``
init method and writes its results to ``<out_dir>/rank<r>.npz``. Imports
torch, numpy and the port only, so a rank starts without JAX."""

import numpy as np
import torch
import torch.distributed as dist


def _problems(inputs):
    from pslam_tpu_torch import interop
    from pslam_tpu_torch.geometry.lie import Sim3
    from pslam_tpu_torch.solver.ba_lil import LILBAEdges
    from pslam_tpu_torch.solver.local_ba import BAProblem
    from pslam_tpu_torch.solver.sim3_graph import PoseGraphProblem

    prob = interop.ba_problem_from_numpy(BAProblem(**inputs["ba"]), device="cpu")
    ledges = interop.lil_ba_edges_from_numpy(LILBAEdges(**inputs["ledges"]), device="cpu")
    lil = {k: torch.from_numpy(v) for k, v in inputs["lil"].items()}
    g = {k: torch.from_numpy(v) for k, v in inputs["graph"].items()}
    graph = PoseGraphProblem(S=Sim3(g["s"], g["R"], g["t"]), fixed=g["fixed"],
                             vertex_valid=g["vertex_valid"], e_i=g["e_i"], e_j=g["e_j"],
                             e_Sji=Sim3(g["e_s"], g["e_R"], g["e_t"]), e_valid=g["e_valid"])
    return prob, lil, ledges, graph


def solve_all(cam, n_free, prob, lil, ledges, graph, sharded: bool):
    """The three solvers, sharded over the current group or single-device;
    a flat dict of numpy results."""
    from pslam_tpu_torch.parallel.sharded_ba import (
        sharded_local_bundle_adjustment,
        sharded_local_bundle_adjustment_lil,
    )
    from pslam_tpu_torch.parallel.sharded_graph import optimize_essential_graph_sharded
    from pslam_tpu_torch.solver.ba_lil import local_bundle_adjustment_lil
    from pslam_tpu_torch.solver.local_ba import local_bundle_adjustment
    from pslam_tpu_torch.solver.sim3_graph import optimize_essential_graph

    ba = sharded_local_bundle_adjustment if sharded else local_bundle_adjustment
    ba_lil = sharded_local_bundle_adjustment_lil if sharded else local_bundle_adjustment_lil
    eg = optimize_essential_graph_sharded if sharded else optimize_essential_graph
    out = dict(zip(("T", "X", "inlier", "chi2"), ba(cam, prob, n_free)))
    out.update(zip(("lil_T", "lil_X", "lil_L", "lil_in_p", "lil_in_l"),
                   ba_lil(cam, prob, lil["state"], lil["valid"], ledges, n_free)))
    out.update(zip(("g_s", "g_R", "g_t"), eg(graph, n_iters=20)))
    return {k: v.numpy() for k, v in out.items()}


def _solvers(rank, world, inputs):
    from pslam_tpu_torch.geometry import Camera

    cam = Camera(**inputs["cam"])
    prob, lil, ledges, graph = _problems(inputs)
    out = solve_all(cam, inputs["n_free"], prob, lil, ledges, graph, sharded=True)
    # An edge length that does not divide by the world size is refused.
    from pslam_tpu_torch.parallel.sharded_ba import sharded_local_bundle_adjustment

    E = prob.cam_idx.shape[0]
    cut = prob._replace(cam_idx=prob.cam_idx[:E - 1], pt_idx=prob.pt_idx[:E - 1],
                        obs=prob.obs[:E - 1], inv_sigma2=prob.inv_sigma2[:E - 1],
                        edge_valid=prob.edge_valid[:E - 1])
    try:
        sharded_local_bundle_adjustment(cam, cut, inputs["n_free"])
        out["refused"] = np.array(False)
    except ValueError:
        out["refused"] = np.array(True)
    return out


def _system(rank, world, inputs):
    """Config 1 with ``distributed=True`` at 320x240 (phase 5's small
    config of chip_smoke.py) over ``inputs["n_frames"]`` frames."""
    from pslam_tpu_torch.geometry import Camera
    from pslam_tpu_torch.io.synthetic import render_sequence
    from pslam_tpu_torch.ops.orb import OrbConfig
    from pslam_tpu_torch.pipeline import system
    from pslam_tpu_torch.utils.config import Capacities, SlamConfig

    sizes = []
    plain = system.local_bundle_adjustment

    def counted(*args, ranks, **kw):
        sizes.append(ranks.size)
        return plain(*args, ranks=ranks, **kw)

    system.local_bundle_adjustment = counted
    try:
        cam = Camera(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320,
                     height=240)
        cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=500),
                         caps=Capacities(local_points=1024), use_lines=False, use_bow=False,
                         use_loop_closing=False, distributed=True)
        grays, depths, poses_gt = render_sequence(cfg.camera, n_frames=inputs["n_frames"],
                                                  seed=0)
        slam = system.SlamSystem(cfg, device="cpu")
        states = []
        for i in range(len(grays)):
            slam.track_rgbd(grays[i], depths[i], i / 30.0)
            states.append(slam.state.name)
        slam.flush()
    finally:
        system.local_bundle_adjustment = plain
    return dict(poses=slam.poses, poses_gt=np.asarray(poses_gt),
                ba_runs=np.array(slam.stats["ba_runs"]),
                sharded_calls=np.array(sizes.count(world)),
                all_ok=np.array(all(s == "OK" for s in states)))


JOBS = {"solvers": _solvers, "system": _system}


def run(rank, world, init_file, jobs, inputs, out_dir):
    """Join the group and run ``jobs`` (names in JOBS) in order; their
    outputs are merged into one file."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        out = {}
        for job in jobs:
            out.update(JOBS[job](rank, world, inputs))
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
