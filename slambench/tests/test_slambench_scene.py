"""The frozen renderer and traffic generator against the port's numpy
renderer, and the published speeds of the two TUM sequences."""

import json

import numpy as np
import pytest
import torch

from slambench import reference, scene
from slambench.traffic import path_poses, replay_index, speeds

from .conftest import BENCH


def _room_pair(seed=3):
    from pslam_tpu_torch.io.synthetic import ClosedRoom

    ref = ClosedRoom(depth=3.5, half_w=3.0, half_h=2.0, tex_size=256, seed=seed)
    ours = scene.Room(3.5, 3.0, 2.0, 256, [torch.from_numpy(t) for t in ref.textures])
    return ref, ours


@pytest.mark.parametrize("traffic", ["fr1desk", "fr2xyz"])
def test_render_matches_port_renderer(traffic):
    ref, ours = _room_pair()
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    poses = path_poses(tr)[::97][:4]
    K = np.array([[129.3, 0, 79.6], [0, 129.1, 63.8], [0, 0, 1]])
    dist = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
    rays = scene.camera_rays((129.3, 129.1, 79.6, 63.8), 160, 120, dist, "cpu")
    g, z = scene.render(ours, rays, torch.from_numpy(poses))
    for b, T in enumerate(poses):
        g_ref, z_ref = ref.render(K, T, 160, 120, dist=dist)
        np.testing.assert_allclose(z[b].numpy(), z_ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g[b].numpy(), g_ref, atol=2e-3)


def test_reference_depth_is_the_rendered_depth():
    _, ours = _room_pair()
    tr = json.loads((BENCH / "traffic" / "fr1desk.json").read_text())
    T = path_poses(tr)[123]
    cam = dict(fx=129.3, fy=129.1, cx=79.6, cy=63.8, k1=0.262383, k2=-0.953104,
               p1=-0.005358, p2=0.002628, k3=1.163314)
    dist = tuple(cam[k] for k in ("k1", "k2", "p1", "p2", "k3"))
    rays = scene.camera_rays((cam["fx"], cam["fy"], cam["cx"], cam["cy"]), 160, 120, dist, "cpu")
    _, z = scene.render(ours, rays, torch.from_numpy(T[None]))
    _, zq = scene.sensor_frames(torch.zeros_like(z), z, 5000.0)
    rng = np.random.default_rng(0)
    px = np.stack([rng.integers(0, 160, 300), rng.integers(0, 120, 300)], axis=1)
    room = dict(depth=3.5, half_w=3.0, half_h=2.0)
    z_ref = reference.true_depth(room, cam, T, px, 5000.0)
    got = zq[0].numpy()[px[:, 1], px[:, 0]]
    np.testing.assert_allclose(got, z_ref, rtol=1e-7)
    z_32 = reference.true_depth(room, cam, T, px, 5000.0, tf32=True)
    assert np.percentile(np.abs(z_32 - z_ref) / z_ref, 99) > 1e-4


@pytest.mark.parametrize("traffic,trans,ang", [("fr1desk", 0.413, 23.327),
                                               ("fr2xyz", 0.058, 1.716)])
def test_published_speeds(traffic, trans, ang):
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    v, w = speeds(path_poses(tr), tr["fps"])
    assert abs(v - trans) / trans < 0.01
    assert abs(w - ang) / ang < 0.01


def test_replay_has_no_jump():
    for name in ("fr1desk", "fr2xyz"):
        tr = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        poses = path_poses(tr)
        n = len(poses)
        stream = np.stack([poses[replay_index(tr, n, i)] for i in range(3 * n)])
        C = np.stack([-p[:3, :3].T @ p[:3, 3] for p in stream])
        step = np.linalg.norm(np.diff(C, axis=0), axis=1)
        v_max = np.linalg.norm(np.diff(np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses]),
                                       axis=0), axis=1).max()
        assert step.max() <= v_max * 1.01 + 1e-9
    tr = {"replay": "pingpong"}
    assert [replay_index(tr, 4, i) for i in range(8)] == [0, 1, 2, 3, 2, 1, 0, 1]


def test_textures_follow_the_seed():
    a = scene.Room.from_seed(2**31 + 17, 3.5, 3.0, 2.0, 64, "cpu")
    b = scene.Room.from_seed(2**31 + 17, 3.5, 3.0, 2.0, 64, "cpu")
    c = scene.Room.from_seed(5, 3.5, 3.0, 2.0, 64, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.textures, b.textures))
    assert not torch.equal(a.textures[0], c.textures[0])
    assert float(a.textures[0].min()) >= 0 and float(a.textures[0].max()) <= 255
