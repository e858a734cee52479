"""The port's sharded solvers (``pslam_tpu_torch/parallel``) over
``torch.distributed`` on the CPU: gloo ranks spawned with
``torch.multiprocessing`` (bodies in tests/torch_parallel_ranks.py), each on
one torch thread, joined through a ``file://`` init method under
``tmp_path`` so that test workers never share a port.

Inputs are those of tests/test_parallel.py: ``TestLocalBA._ba_problem(
seed=11)`` padded to multiples of 8, the LIL problem of
``test_sharded_lil_matches_single_device`` and ``_drift_pose_graph``. Bars
are that file's: poses within 5e-3, median point difference under 1e-3,
LIL states within 5e-3, inlier masks 99% equal, essential-graph R and t
within 1e-3; against the port's single-device solvers and against the JAX
package's (its scatter BA assembly, ``PSLAM_BA_ONEHOT=0``). Every rank
returns the same arrays; at world size 1 the sharded solvers equal the
single-device ones bit for bit. The system runs config 1 with
``distributed=True`` in two ranks (tests/test_parallel.py's
``test_system_with_distributed_ba``, at 320x240; both two-rank runs share
one spawn) and, with no process group, exactly as
``distributed=False``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

import torch_parallel_ranks as ranks
from test_lil import _make_lils
from test_parallel import _drift_pose_graph
from test_solver import CAM
from test_solver import TestLocalBA as _BAHelper  # noqa: N813 (not collected)

from pslam_tpu.solver.ba_lil import LILBAEdges as JLILBAEdges
from pslam_tpu.solver.ba_lil import local_bundle_adjustment_lil as j_lba_lil
from pslam_tpu.solver.local_ba import local_bundle_adjustment as j_lba
from pslam_tpu.solver.sim3_graph import optimize_essential_graph as j_eg
from pslam_tpu_torch.geometry import Camera as TCam


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs (the ranks
    set one thread each): the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(a, n, fill=0):
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a
    return out


def _inputs():
    """The numpy inputs of tests/test_parallel.py's three solver tests."""
    prob, T_true, _, n_free = _BAHelper()._ba_problem(seed=11)
    E = len(np.asarray(prob.cam_idx))
    E_pad = -(-E // 8) * 8
    P_n = len(np.asarray(prob.point_valid))
    P_pad = -(-P_n // 8) * 8
    ba = dict(T_cw=np.asarray(prob.T_cw), free_slot=np.asarray(prob.free_slot),
              X_w=_pad(prob.X_w, P_pad), point_valid=_pad(prob.point_valid, P_pad, False),
              cam_idx=_pad(prob.cam_idx, E_pad), pt_idx=_pad(prob.pt_idx, E_pad),
              obs=_pad(prob.obs, E_pad), inv_sigma2=_pad(prob.inv_sigma2, E_pad, 1.0),
              edge_valid=_pad(prob.edge_valid, E_pad, False))

    rng = np.random.default_rng(7)
    Q, C = 8, len(ba["T_cw"])
    le_cam, le_lil, le_obs, lil_states = [], [], [], None
    for c in range(C):
        st_c, obs_c = _make_lils(np.random.default_rng(7), Q, T_cw=T_true[c])
        if lil_states is None:
            lil_states = st_c
        le_cam.extend([c] * Q)
        le_lil.extend(range(Q))
        le_obs.append(obs_c)
    El = len(le_cam)
    El_pad = -(-El // 8) * 8
    ledges = dict(cam_idx=_pad(np.asarray(le_cam, np.int32), El_pad),
                  lil_idx=_pad(np.asarray(le_lil, np.int32), El_pad),
                  obs=_pad(np.concatenate(le_obs).astype(np.float32), El_pad),
                  valid=_pad(np.ones(El, bool), El_pad, False))
    lil = dict(state=lil_states + np.tile(rng.normal(0, 0.05, (Q, 3)).astype(np.float32),
                                          (1, 5)),
               valid=np.ones(Q, bool))

    g, _ = _drift_pose_graph()
    graph = dict(s=np.asarray(g.S.s), R=np.asarray(g.S.R), t=np.asarray(g.S.t),
                 fixed=np.asarray(g.fixed), vertex_valid=np.asarray(g.vertex_valid),
                 e_i=np.asarray(g.e_i).astype(np.int64), e_j=np.asarray(g.e_j).astype(np.int64),
                 e_s=np.asarray(g.e_Sji.s), e_R=np.asarray(g.e_Sji.R),
                 e_t=np.asarray(g.e_Sji.t), e_valid=np.asarray(g.e_valid))
    return dict(cam=dataclasses.asdict(CAM), n_free=n_free, ba=ba, ledges=ledges, lil=lil,
                graph=graph), g


@pytest.fixture(scope="module")
def solved():
    """(inputs, the port's single-device results, JAX's)."""
    inputs, g = _inputs()
    single = ranks.solve_all(TCam(**inputs["cam"]), inputs["n_free"],
                             *ranks._problems(inputs), sharded=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PSLAM_BA_ONEHOT", "0")
        jax.clear_caches()
        from pslam_tpu.solver.local_ba import BAProblem as JBAProblem

        prob = JBAProblem(**{k: jnp.asarray(v) for k, v in inputs["ba"].items()})
        ledges = JLILBAEdges(**{k: jnp.asarray(v) for k, v in inputs["ledges"].items()})
        n_free = inputs["n_free"]
        out = dict(zip(("T", "X", "inlier", "chi2"), j_lba(CAM, prob, n_free)))
        out.update(zip(("lil_T", "lil_X", "lil_L", "lil_in_p", "lil_in_l"),
                       j_lba_lil(CAM, prob, jnp.asarray(inputs["lil"]["state"]),
                                 jnp.asarray(inputs["lil"]["valid"]), ledges, n_free)))
        S = j_eg(g, n_iters=20)
        out.update(g_s=S.s, g_R=S.R, g_t=S.t)
        jax_out = {k: np.asarray(v) for k, v in jax.device_get(out).items()}
    jax.clear_caches()
    return inputs, single, jax_out


def _spawn(world, jobs, inputs, tmp_path):
    tmp.spawn(ranks.run, args=(world, str(tmp_path / "init"), jobs, inputs, str(tmp_path)),
              nprocs=world, join=True)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(solved, tmp_path_factory):
    """One spawn of two ranks for the solvers and the system run."""
    inputs = dict(solved[0], n_frames=10)
    return _spawn(2, ("solvers", "system"), inputs, tmp_path_factory.mktemp("two_ranks"))


def _close(got, ref, label):
    """tests/test_parallel.py's bars."""
    np.testing.assert_allclose(got["T"], ref["T"], atol=5e-3, err_msg=label)
    assert np.median(np.abs(got["X"] - ref["X"])) < 1e-3, label
    assert np.mean(got["inlier"] == ref["inlier"]) > 0.99, label
    np.testing.assert_allclose(got["lil_T"], ref["lil_T"], atol=5e-3, err_msg=label)
    assert np.median(np.abs(got["lil_X"] - ref["lil_X"])) < 1e-3, label
    np.testing.assert_allclose(got["lil_L"], ref["lil_L"], atol=5e-3, err_msg=label)
    assert np.mean(got["lil_in_p"] == ref["lil_in_p"]) > 0.99, label
    np.testing.assert_allclose(got["g_t"], ref["g_t"], atol=1e-3, err_msg=label)
    np.testing.assert_allclose(got["g_R"], ref["g_R"], atol=1e-3, err_msg=label)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solvers_match_single_device(solved, world, tmp_path, request):
    inputs, single, jax_out = solved
    outs = (request.getfixturevalue("two_ranks") if world == 2
            else _spawn(world, ("solvers",), inputs, tmp_path))
    for r, out in enumerate(outs):
        assert bool(out["refused"]), f"rank {r} accepted an edge length E - 1"
        for k in single:
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=f"rank {r} {k}")
    _close(outs[0], single, f"{world} ranks vs the port's single-device solvers")
    _close(outs[0], jax_out, f"{world} ranks vs JAX's single-device solvers")
    # The LIL structures moved toward the solution.
    assert not np.allclose(outs[0]["lil_L"], inputs["lil"]["state"])


def test_sharded_world_size_one_is_bit_identical(solved, tmp_path):
    inputs, single, _ = solved
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        out = ranks.solve_all(TCam(**inputs["cam"]), inputs["n_free"],
                              *ranks._problems(inputs), sharded=True)
    finally:
        dist.destroy_process_group()
    for k in single:
        np.testing.assert_array_equal(out[k], single[k], err_msg=k)


def test_sharded_solvers_need_a_process_group(solved):
    from pslam_tpu_torch.parallel import sharded_local_bundle_adjustment, world_size

    inputs, _, _ = solved
    assert world_size() == 1
    prob = ranks._problems(inputs)[0]
    with pytest.raises(RuntimeError):
        sharded_local_bundle_adjustment(TCam(**inputs["cam"]), prob, inputs["n_free"])


def test_system_with_distributed_ba_two_ranks(two_ranks):
    """Config 1 with distributed=True in two gloo ranks over 10 frames at
    320x240: the local BA runs sharded, ATE < 5 cm, the same trajectory on
    both ranks."""
    from pslam_tpu_torch.utils.metrics import ate_rmse, trajectory_positions

    outs = two_ranks
    for out in outs:
        assert bool(out["all_ok"])
        assert int(out["ba_runs"]) >= 1 and int(out["sharded_calls"]) >= 1
        ate = ate_rmse(trajectory_positions(out["poses"]),
                       trajectory_positions(out["poses_gt"]))
        assert ate < 0.05, f"ATE {ate:.4f} m with distributed BA"
    np.testing.assert_array_equal(outs[0]["poses"], outs[1]["poses"])


def test_distributed_without_process_group_is_the_plain_path():
    """With no process group (or one rank) distributed=True takes the plain
    solvers, as the JAX package does on one device: the trajectory and the
    map equal distributed=False's exactly."""
    from pslam_tpu_torch.io.synthetic import arc_trajectory, render_sequence
    from pslam_tpu_torch.ops.orb import OrbConfig
    from pslam_tpu_torch.pipeline.system import SlamSystem
    from pslam_tpu_torch.utils.config import Capacities, SlamConfig

    cam = TCam(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320, height=240)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=500),
                     caps=Capacities(local_points=1024), use_lines=False, use_bow=False,
                     use_loop_closing=False)
    grays, depths, _ = render_sequence(cam, n_frames=4, poses=arc_trajectory(24)[:4], seed=0)
    runs = []
    for distributed in (False, True):
        slam = SlamSystem(dataclasses.replace(cfg, distributed=distributed), device="cpu")
        for i in range(len(grays)):
            slam.track_rgbd(grays[i], depths[i], i / 30.0)
        slam.flush()  # commit the local BA of the fourth frame
        runs.append((slam.poses, slam.map, slam.stats["ba_runs"]))
    assert runs[0][2] >= 1
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for k, v in vars(runs[0][1]).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, getattr(runs[1][1], k), err_msg=k)
