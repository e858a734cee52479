"""The local BA's graph dispatch (``solver/local_ba.BA_GRAPHS``,
``utils/cuda_graph.GraphCache``) on the CPU: which solves go through it, the
first-sight policy and the keys through a stub capture (the CPU has no CUDA
graphs), the fixed-width tables, and the constants the solve no longer
copies to the device. The card's replays against eager are chip_smoke.py's
phase 3c."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from pslam_tpu_torch.geometry import Camera, se3_exp
from pslam_tpu_torch.parallel.sharded_ba import (
    sharded_local_bundle_adjustment,
    sharded_local_bundle_adjustment_lil,
)
from pslam_tpu_torch.solver import local_ba
from pslam_tpu_torch.solver.ba_lil import LILBAEdges, local_bundle_adjustment_lil
from pslam_tpu_torch.solver.local_ba import (
    CHI2_MONO,
    CHI2_STEREO,
    AssemblyPlan,
    BAProblem,
    assembly_plan,
    local_bundle_adjustment,
    pow2_width,
    segment_sum,
    segment_table,
)
from pslam_tpu_torch.utils.cuda_graph import GraphCache

CAM = Camera(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320, height=240)
N_FREE = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(a, m, fill=0):
    a = np.asarray(a)
    out = np.full((m,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a
    return torch.from_numpy(out)


def _problem(seed=3, C=6, P=64, E=512, Q=8, El=64):
    """A small point + LIL problem near its truth: 4 free cameras of 6, P
    points (8 padding) seen 2-4 times, some edges mono; Q LILs seen by
    every camera. Returns (BAProblem, lil_state, lil_valid, LILBAEdges)."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((C, 6), np.float32)
    xi[:, 3] = np.linspace(-0.3, 0.3, C)
    T = se3_exp(torch.from_numpy(xi))
    n_pts = P - 8
    X = torch.from_numpy(rng.uniform([-1.5, -1, 2], [1.5, 1, 4], (n_pts, 3)).astype(np.float32))
    pairs = [(c, p) for p in range(n_pts)
             for c in rng.choice(C, size=rng.integers(2, 5), replace=False)]
    ci, pi = (np.asarray(a, np.int64) for a in zip(*pairs))
    Xc = torch.einsum("eij,ej->ei", T[ci, :3, :3], X[pi]) + T[ci, :3, 3]
    u = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
    v = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
    obs = torch.stack([u, v, u - CAM.bf / Xc[:, 2]], 1).numpy()
    obs += rng.normal(0, 0.5, obs.shape).astype(np.float32)
    obs[rng.uniform(size=len(ci)) < 0.3, 2] = -1.0
    n = len(ci)
    dT = se3_exp(torch.from_numpy(rng.normal(0, 0.01, (C, 6)).astype(np.float32)))
    prob = BAProblem(
        T_cw=torch.cat([dT[:N_FREE] @ T[:N_FREE], T[N_FREE:]]),
        free_slot=torch.from_numpy(np.r_[np.arange(N_FREE), -np.ones(C - N_FREE)]).long(),
        X_w=_pad(X.numpy() + rng.normal(0, 0.02, (n_pts, 3)).astype(np.float32), P),
        point_valid=_pad(np.ones(n_pts, bool), P),
        cam_idx=_pad(ci, E), pt_idx=_pad(pi, E), obs=_pad(obs, E),
        inv_sigma2=_pad(rng.choice([1.0, 1 / 1.44], n).astype(np.float32), E, 1.0),
        edge_valid=_pad(np.ones(n, bool), E),
    )

    def line(a, b):
        eq = np.array([a[1] - b[1], b[0] - a[0], a[0] * b[1] - a[1] * b[0]])
        return eq / np.hypot(eq[0], eq[1])

    states = []
    for _ in range(Q):
        Xq = rng.uniform([-1, -0.7, 2.5], [1, 0.7, 3.5])
        d1 = rng.normal(size=3)
        d1 /= np.linalg.norm(d1)
        d2 = np.cross(d1, rng.normal(size=3))
        d2 /= np.linalg.norm(d2)
        states.append(np.concatenate([Xq - 0.3 * d1, Xq + 0.4 * d1, Xq - 0.3 * d2,
                                      Xq + 0.2 * d2, Xq]))
    states = torch.from_numpy(np.asarray(states, np.float32))
    le_obs = []
    for c in range(C):
        pts = states.reshape(Q, 5, 3) @ T[c, :3, :3].T + T[c, :3, 3]
        uv = torch.stack([CAM.fx * pts[..., 0] / pts[..., 2] + CAM.cx,
                          CAM.fy * pts[..., 1] / pts[..., 2] + CAM.cy], -1).numpy()
        le_obs += [np.concatenate([line(uv[q, 0], uv[q, 1]), line(uv[q, 2], uv[q, 3]), uv[q, 4]])
                   for q in range(Q)]
    m = C * Q
    ledges = LILBAEdges(cam_idx=_pad(np.repeat(np.arange(C), Q), El),
                        lil_idx=_pad(np.tile(np.arange(Q), C), El),
                        obs=_pad(np.asarray(le_obs, np.float32), El),
                        valid=_pad(np.ones(m, bool), El))
    shift = np.tile(rng.normal(0, 0.03, (Q, 3)).astype(np.float32), (1, 5))
    return prob, states + torch.from_numpy(shift), torch.ones(Q, dtype=torch.bool), ledges


class StubGraphs(GraphCache):
    """A cache that takes CPU tensors and 'captures' by remembering ``fn``:
    a replay recomputes it on the static inputs and writes the static
    outputs in place, as a CUDA graph's replay does."""

    DEVICE_TYPES = ("cpu",)

    def _capture(self, fn):
        out = fn()

        def replay():
            for o, n in zip(tree_leaves(out), tree_leaves(fn())):
                o.copy_(n)

        return replay, out


def _solve_points(prob):
    return local_bundle_adjustment(CAM, prob, N_FREE)


def _solve_lil(prob, lil_state, lil_valid, ledges):
    return local_bundle_adjustment_lil(CAM, prob, lil_state, lil_valid, ledges, N_FREE)


def _counts(g):
    return g.eager, g.captures, g.replays


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture
def stub(monkeypatch):
    g = StubGraphs()
    monkeypatch.setattr(local_ba, "BA_GRAPHS", g)
    return g


def test_cpu_solves_never_reach_the_cache(problem):
    prob, lil_state, lil_valid, ledges = problem
    g = local_ba.BA_GRAPHS
    before = _counts(g), len(g.seen), len(g.graphs)
    for _ in range(2):
        _solve_points(prob)
        _solve_lil(prob, lil_state, lil_valid, ledges)
    assert (_counts(g), len(g.seen), len(g.graphs)) == before
    assert not local_ba.graphs_engage(prob.T_cw, local_ba.ONE_DEVICE)


def test_sharded_solves_never_reach_the_cache(problem, stub, tmp_path):
    """A ``Ranks`` solve runs eagerly even where the cache would take its
    device; the plain solve on the same device does reach it."""
    prob, lil_state, lil_valid, ledges = problem
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        for _ in range(3):
            sharded_local_bundle_adjustment(CAM, prob, N_FREE)
            sharded_local_bundle_adjustment_lil(CAM, prob, lil_state, lil_valid, ledges, N_FREE)
    finally:
        dist.destroy_process_group()
    assert _counts(stub) == (0, 0, 0) and not stub.seen
    _solve_points(prob)
    assert _counts(stub) == (1, 0, 0)


@pytest.mark.parametrize("solver", ["points", "lil"])
def test_first_sight_eager_second_captures_then_replays(problem, stub, solver):
    """Per key: one eager call, one capture (which replays), then replays,
    every one equal to the eager result; another shape, camera or schedule
    is another key; a result held survives the next replay."""
    prob, lil_state, lil_valid, ledges = problem

    def solve(p, cam=CAM, schedule=(5, 10)):
        if solver == "points":
            return local_bundle_adjustment(cam, p, N_FREE, schedule)
        return local_bundle_adjustment_lil(cam, p, lil_state, lil_valid, ledges, N_FREE,
                                           schedule)

    eager = solve(prob)
    assert _counts(stub) == (1, 0, 0)
    first = solve(prob)
    assert _counts(stub) == (1, 1, 1) and _equal(first, eager)
    held = tuple(t.clone() for t in first)
    moved = prob._replace(X_w=prob.X_w + 0.01 * prob.point_valid[:, None])
    other = solve(moved)
    assert _counts(stub) == (1, 1, 2) and not _equal(other, first)
    assert _equal(first, held)
    assert _equal(solve(prob), eager) and _counts(stub) == (1, 1, 3)
    # Another key: a longer edge axis, another camera, another schedule.
    longer = prob._replace(**{k: torch.cat([getattr(prob, k), getattr(prob, k)[-64:]])
                              for k in ("cam_idx", "pt_idx", "obs", "inv_sigma2", "edge_valid")})
    solve(longer)
    solve(prob, cam=dataclasses.replace(CAM, fx=260.0))
    solve(prob, schedule=(3, 4))
    assert _counts(stub) == (4, 1, 3) and len(stub.graphs) == 1


def test_a_key_holds_every_input_shape(stub):
    a = (torch.zeros(3), torch.zeros(2, dtype=torch.int64))
    for _ in range(2):
        stub.run("k", lambda x, y: (x + 1, y * 2), *a)
    stub.run("k", lambda x, y: (x + 1, y * 2), torch.zeros(4), a[1])
    stub.run("k", lambda x, y: (x + 1, y * 2), a[0], a[1].int())
    stub.run("j", lambda x, y: (x + 1, y * 2), *a)
    assert _counts(stub) == (4, 1, 1) and len(stub.seen) == 4


def test_nested_arguments_pass_whole_and_key_their_structure(stub):
    """Tuples and NamedTuples of tensors reach ``fn`` as they were given,
    on the capture and on a replay too; the same tensors in another
    structure are another key."""
    plan = AssemblyPlan(torch.ones(2), torch.ones(3), torch.ones(1))

    def fn(x, pair):
        p, q = pair
        assert isinstance(p, AssemblyPlan)
        return x + p.lm.sum(), (q * 2, p.cam + 1)

    for k in range(3):
        x = torch.full((2,), float(k))
        out = stub.run("k", fn, x, (plan, torch.ones(4)))
        assert torch.equal(out[0], x + 3) and torch.equal(out[1][0], torch.full((4,), 2.0))
    assert _counts(stub) == (1, 1, 2)
    stub.run("k", lambda x, pair: fn(x, pair[::-1]), x, (torch.ones(4), plan))
    assert _counts(stub) == (2, 1, 2)


@pytest.mark.parametrize("k,least,width", [(0, 1, 1), (1, 1, 1), (2, 1, 2), (3, 1, 4),
                                           (300, 1, 512), (513, 1, 1024), (20, 64, 64),
                                           (64, 64, 64), (65, 64, 128)])
def test_pow2_width(k, least, width):
    assert pow2_width(k, least) == width


def test_tables_list_every_edge_in_order():
    """Three edges on one target: width 3, a power of two (4) given a
    ``least``, and at least that ``least``; each row in edge order, padded
    with E."""
    target = torch.tensor([2, 0, 2, 2, 1])
    assert segment_table(target, 3).tolist() == [[1, 5, 5], [4, 5, 5], [0, 2, 3]]
    assert segment_table(target, 3, least=1).tolist() == [[1, 5, 5, 5], [4, 5, 5, 5],
                                                          [0, 2, 3, 5]]
    assert segment_table(target, 3, least=8).shape == (3, 8)


@pytest.mark.parametrize("seed", [0, 1])
def test_a_wider_table_sums_the_same_edges(seed):
    """Zero columns on the right of a table add no edge: on rows of whole
    numbers, which sum exactly in any order, the sums equal bit for bit at
    any width; on random rows they agree to f32 rounding (the widest gap
    read was 1.9e-6 over 20 seeds), since a ``sum``'s order of additions
    changes with the width."""
    rng = np.random.default_rng(seed)
    E, n = 700, 11
    target = torch.from_numpy(rng.integers(-2, n + 2, E))
    whole = torch.from_numpy(rng.integers(-8, 9, (E, 6, 6)).astype(np.float32))
    vals = torch.from_numpy(rng.normal(size=(E, 6, 6)).astype(np.float32))
    table = segment_table(target, n)
    for w in (1, 2, 3, 16, 200):
        wide = torch.cat([table, torch.full((n, w), E)], dim=1)
        for shape in ((E, 6, 6), (E, 6, 3), (E, 6), (E,)):
            rows = whole.reshape(E, -1)[:, : int(np.prod(shape[1:]))].reshape(shape)
            assert torch.equal(segment_sum(rows, wide), segment_sum(rows, table))
        torch.testing.assert_close(segment_sum(vals, wide), segment_sum(vals, table),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("solver", ["points", "lil"])
def test_fixed_width_tables_give_the_same_sums(problem, solver):
    """The padded tables list the same edges, in the same order, as
    ``segment_table``'s, padded with E (a zero row): every block sums the
    same edges (exactly, on rows of whole numbers), and the whole solve on
    them keeps every inlier flag and agrees to rounding carried through 15
    LM steps (read over 4 seeds: poses 5.6e-5, points 6.2e-4 on a 4 m
    scene)."""
    prob, lil_state, lil_valid, ledges = problem
    if solver == "points":
        cam_idx, lm_idx, valid, n_lm = prob.cam_idx, prob.pt_idx, prob.edge_valid, 64
    else:
        cam_idx, lm_idx, valid, n_lm = ledges.cam_idx, ledges.lil_idx, ledges.valid, 8
    # 16 cameras, so the landmark tables widen to 16 from at most 6, and the
    # free cameras' to E / 4 at least.
    free_slot = torch.cat([prob.free_slot, torch.full((10,), -1)])
    plain = assembly_plan(free_slot, cam_idx, lm_idx, valid, N_FREE, n_lm)
    fixed = assembly_plan(free_slot, cam_idx, lm_idx, valid, N_FREE, n_lm, fixed=True)
    E = cam_idx.shape[0]
    assert plain.lm.shape[1] <= 6 and fixed.lm.shape[1] == 16
    assert fixed.cam.shape[1] == pow2_width(plain.cam.shape[1], E // N_FREE)
    assert fixed.lm_cam.shape[1] == pow2_width(plain.lm_cam.shape[1])
    rng = np.random.default_rng(1)
    whole = torch.from_numpy(rng.integers(-8, 9, (E, 6, 3)).astype(np.float32))
    for a, b in zip(plain, fixed):
        assert torch.equal(b[:, : a.shape[1]], a) and bool((b[:, a.shape[1]:] == E).all())
        assert torch.equal(segment_sum(whole, b), segment_sum(whole, a))
    prob = prob._replace(T_cw=torch.cat([prob.T_cw, torch.eye(4).expand(10, 4, 4)]),
                         free_slot=free_slot)
    plan_p = assembly_plan(prob.free_slot, prob.cam_idx, prob.pt_idx, prob.edge_valid, N_FREE,
                           64, fixed=True)
    if solver == "points":
        got = local_ba._solve(CAM, prob, N_FREE, (5, 10), local_ba.ONE_DEVICE, plan_p)
        want = _solve_points(prob)
        T, X, flags = (0, 1, (2,))
    else:
        from pslam_tpu_torch.solver import ba_lil

        got = ba_lil._solve(CAM, prob, lil_state, lil_valid, ledges, N_FREE, (5, 10),
                            local_ba.ONE_DEVICE, (plan_p, fixed))
        want = _solve_lil(prob, lil_state, lil_valid, ledges)
        T, X, flags = (0, 1, (3, 4))
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=5e-4)
    for k in flags:
        assert torch.equal(got[k], want[k])
    torch.testing.assert_close(got[T], want[T], rtol=0, atol=5e-4)
    torch.testing.assert_close(got[X], want[X], rtol=0, atol=5e-3)


def test_hoisted_constants_equal_the_device_scalars(problem):
    """The gates and Huber deltas, now Python floats, equal the device
    scalars the solve built before, in f32 and f64."""
    prob = problem[0]
    is_stereo, gate = local_ba._gates(prob)
    old = torch.where(is_stereo, torch.tensor(CHI2_STEREO), torch.tensor(CHI2_MONO))
    assert gate.dtype == old.dtype and torch.equal(gate, old)
    for dtype in (torch.float32, torch.float64):
        for c in (CHI2_STEREO, CHI2_MONO):
            assert local_ba._huber_delta(c, dtype) == torch.tensor(c, dtype=dtype).sqrt().item()
    T64, X64 = prob.T_cw.double(), prob.X_w.double()
    p64 = prob._replace(obs=prob.obs.double(), inv_sigma2=prob.inv_sigma2.double())
    chi2, w_eff, *_ = local_ba._edge_terms(CAM, p64, T64, X64, prob.edge_valid, True)
    assert w_eff.dtype == torch.float64
    delta = torch.where(is_stereo, torch.tensor(CHI2_STEREO, dtype=torch.float64).sqrt(),
                        torch.tensor(CHI2_MONO, dtype=torch.float64).sqrt())
    assert torch.equal(w_eff, local_ba.huber_weight(chi2, delta) * p64.inv_sigma2
                       * prob.edge_valid.double())
