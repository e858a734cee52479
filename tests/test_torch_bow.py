"""BoW place recognition: the vocabulary, the tree descent, the scores and
the keyframe database, the JAX package against the port on the same numpy
inputs (CPU).

Bars: the port's packaged vocabulary is a byte-identical copy of the JAX
package's; the numpy trainer gives identical trees; ``transform``'s words
and nodes are exact and its BoW vector within 1e-6, on random descriptors
and on the ORB descriptors of a rendered ClosedRoom frame with the packaged
10^4-word vocabulary; ``shared_words``, the group mask and the database's
relocalization and loop candidates are exact. ``score_l1`` is a float sum
over the words in an order each framework picks: it differs from JAX's by
up to 3 ulp (3.6e-7) on 40 x 40 random BoW pairs, so its bar is the BoW
vector's 1e-6. The database scores on the host with numpy, as JAX's does.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pslam_tpu.io.synthetic import ClosedRoom, loop_trajectory, render_sequence
from pslam_tpu.models.map_state import MapState as JMap
from pslam_tpu.ops import bow as jbow
from pslam_tpu.pipeline.keyframe_db import KeyFrameDatabase as JDB
from pslam_tpu.utils.config import SlamConfig as JCfg
from pslam_tpu_torch import interop
from pslam_tpu_torch.ops import bow as tbow
from pslam_tpu_torch.ops.orb import OrbConfig as TOrb, extract_orb as t_extract_orb
from pslam_tpu_torch.utils.config import SlamConfig as TCfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several worker processes, and torch's default of a thread a
    core in each of them oversubscribes the host and slows these tests up
    to tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(desc, n_bits, rng):
    """Flip n_bits random bits in each packed descriptor."""
    bits = np.unpackbits(desc, axis=-1, bitorder="little")
    for i in range(len(bits)):
        bits[i, rng.choice(256, n_bits, replace=False)] ^= 1
    return np.packbits(bits, axis=-1, bitorder="little")


@pytest.fixture(scope="module")
def vocabs():
    """A k=8, 4-level vocabulary trained by the JAX package, and its copy."""
    descs = np.random.default_rng(0).integers(0, 256, (4096, 32), dtype=np.uint8)
    vj = jbow.train_vocabulary(descs, k=8, levels=4, seed=1)
    return vj, interop.vocabulary_from_numpy(vj, device="cpu")


@pytest.fixture(scope="module")
def packaged():
    vj = jbow.default_vocabulary(k=10, levels=4)
    vt = tbow.default_vocabulary(k=10, levels=4, device="cpu")
    return vj, vt


def test_packaged_vocabulary_is_a_byte_identical_copy(packaged):
    assert filecmp.cmp(tbow.PACKAGED_VOCAB, jbow.PACKAGED_VOCAB, shallow=False)
    vj, vt = packaged
    assert vt.n_words == 10_000 and vt.k == 10 and vt.levels == 4
    for a, b in zip(vj.node_desc, vt.node_desc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(vt.idf.numpy(), np.asarray(vj.idf))


def test_trainer_gives_the_jax_tree():
    descs = np.random.default_rng(5).integers(0, 256, (600, 32), dtype=np.uint8)
    vj = jbow.train_vocabulary(descs, k=5, levels=3, seed=2)
    vt = tbow.train_vocabulary(descs, k=5, levels=3, seed=2, device="cpu")
    for a, b in zip(vj.node_desc, vt.node_desc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(vt.idf.numpy(), np.asarray(vj.idf))


def _transform_both(vj, vt, desc, valid):
    bj, wj, nj = jax.device_get(jbow.transform(vj, jnp.asarray(desc), jnp.asarray(valid)))
    bt, wt, nt = tbow.transform(vt, torch.from_numpy(desc), torch.from_numpy(valid))
    np.testing.assert_array_equal(wt.numpy(), wj)
    np.testing.assert_array_equal(nt.numpy(), nj)
    np.testing.assert_allclose(bt.numpy(), bj, atol=1e-6, rtol=0)
    return bj, bt.numpy()


def test_transform_random_descriptors(vocabs):
    vj, vt = vocabs
    rng = np.random.default_rng(2)
    desc = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    desc[100:110] = desc[0]  # repeated words
    valid = np.arange(300) < 260
    _transform_both(vj, vt, desc, valid)


def test_transform_orb_of_a_rendered_frame(packaged):
    vj, vt = packaged
    cfg = TCfg()
    poses = loop_trajectory(16, loops=1.0)
    room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=5)
    grays, _, _ = render_sequence(cfg.camera, poses=poses[:1], room=room)
    f = t_extract_orb(torch.from_numpy(grays[0]), TOrb())
    desc, valid = f.desc.numpy(), f.valid.numpy()
    assert valid.sum() > 500
    _transform_both(vj, vt, desc, valid)


def test_scores(vocabs):
    vj, vt = vocabs
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (128, 32), dtype=np.uint8)
    rows = [base, _perturb(base, 8, rng), rng.integers(0, 256, (128, 32), dtype=np.uint8)]
    v = np.ones(128, bool)
    bows = np.stack([_transform_both(vj, vt, d, v)[1] for d in rows])
    q, db = bows[0], bows[1:]
    np.testing.assert_allclose(
        tbow.score_l1(torch.from_numpy(q), torch.from_numpy(db)).numpy(),
        np.asarray(jbow.score_l1(jnp.asarray(q), jnp.asarray(db))), atol=1e-6, rtol=0,
    )
    np.testing.assert_array_equal(
        tbow.shared_words(torch.from_numpy(q), torch.from_numpy(db)).numpy(),
        np.asarray(jbow.shared_words(jnp.asarray(q), jnp.asarray(db))),
    )
    na, nb = rng.integers(-1, 6, 40), rng.integers(-1, 6, 50)
    np.testing.assert_array_equal(
        tbow.bow_group_mask(torch.from_numpy(na), torch.from_numpy(nb)).numpy(),
        np.asarray(jbow.bow_group_mask(jnp.asarray(na), jnp.asarray(nb))),
    )


def test_database_candidates_exact(vocabs):
    """tests/test_place_recognition.py's four places, eight keyframes, plus
    covisibility so that the group accumulation and the loop query's
    neighbour exclusion have something to do."""
    vj, vt = vocabs
    cfg = JCfg()
    ms = JMap(cfg)
    N = cfg.orb.capacity
    rng = np.random.default_rng(5)
    dbj = JDB(vj, cfg.caps.max_keyframes, N)
    place = [rng.integers(0, 256, (N, 32), dtype=np.uint8) for _ in range(4)]
    uv = rng.uniform(0, 400, (N, 2)).astype(np.float32)
    for i in range(8):
        desc = _perturb(place[i % 4], 6, rng)
        k = ms.add_keyframe(
            i, float(i), np.eye(4, dtype=np.float32), uv, np.full(N, -1, np.float32),
            np.zeros(N, np.int32), np.zeros(N, np.float32), desc, np.ones(N, bool),
            np.ones(N, np.float32), np.full(N, -1, np.int32),
        )
        dbj.add(k, *dbj.compute_bow(desc, np.ones(N, bool)))
    for a, b, w in ((2, 6, 40), (2, 3, 20), (6, 7, 30), (1, 5, 25)):
        ms.covis[a, b] = ms.covis[b, a] = w

    mt = interop.map_state_from_arrays(TCfg(), vars(ms))
    dbt = interop.keyframe_db_from_numpy(dbj, vt)
    for i in range(8):  # the port's own rows agree with the JAX rows
        b, w, nd = dbt.compute_bow(ms.kf_desc[i], np.ones(N, bool))
        np.testing.assert_array_equal(w, dbj.word[i])
        np.testing.assert_array_equal(nd, dbj.node[i])
        np.testing.assert_allclose(b, dbj.bow[i], atol=1e-6, rtol=0)

    for qp in range(4):
        bq = dbj.compute_bow(_perturb(place[qp], 6, rng), np.ones(N, bool))[0]
        cj = dbj.detect_relocalization_candidates(bq, ms)
        ct = dbt.detect_relocalization_candidates(bq, mt)
        assert len(cj) > 0
        np.testing.assert_array_equal(ct, cj)
    for kq in range(8):
        np.testing.assert_array_equal(
            dbt.detect_loop_candidates(kq, 0.0, mt), dbj.detect_loop_candidates(kq, 0.0, ms)
        )
    dbj.erase(6)
    dbt.erase(6)
    bq = dbj.bow[2]
    np.testing.assert_array_equal(dbt.detect_relocalization_candidates(bq, mt),
                                  dbj.detect_relocalization_candidates(bq, ms))
