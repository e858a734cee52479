"""The device-trace arithmetic and the per-layer readers on fixed inputs."""

import pytest
import torch

from slambench import harness, stats
from slambench.trace import DeviceTrace, Spans

from .conftest import BENCH


def _trace():
    # (name, start ns, end ns, launching host ns)
    acts = [("k_a", 0, 100, 5), ("k_b", 50, 150, 15), ("k_c", 400, 500, 25),
            ("k_d", 900, 1000, 95)]
    ranges = {"tracking": [(0, 30)], "k1": [(10, 20)], "mapping": [(90, 99)]}
    return DeviceTrace(acts, ranges, window_s=1e-6)


def test_busy_union_and_attribution():
    t = _trace()
    assert t.busy_s() == pytest.approx(350e-9)
    assert [a[0] for a in t.under("tracking")] == ["k_a", "k_b", "k_c"]
    assert [a[0] for a in t.under("k1")] == ["k_b"]
    assert t.top_ops(2) == [["k_a", 1e-7], ["k_b", 1e-7]]
    gaps = dict(map(tuple, t.idle_gaps(["tracking", "mapping"])))
    assert gaps == {"outside spans": pytest.approx(650e-9)}


def test_readers_on_fixed_spans_and_trace():
    spans = Spans()
    spans.records["system"] = [(0.0, 0.5), (1.0, 1.5)]
    spans.records["tracking"] = [(0.1, 0.45), (1.1, 1.45)]
    spans.records["mapping"] = [(0.2, 0.3)]
    spans.captured["k2"] = [4096, 4096]
    acts = [("fused_pose", 0, 2000, 5), ("fused_pose", 5000, 7000, 15)]
    t = DeviceTrace(acts, {"k2": [(0, 10), (10, 20)], "tracking": [(0, 30)]}, 1e-5)
    run = harness.LayerRun(spans, t, {"ba_runs": 0})
    read = lambda name: harness.layer_reader(name).read(run)
    assert read("system.self_ms") == pytest.approx(150.0)
    assert read("tracking.ms_per_frame") == pytest.approx(300.0)
    assert read("mapping.ms_per_kf") == pytest.approx(100.0)
    assert read("local_ba.ms_per_call") is None
    assert read("tracking.launches_per_frame") == 2
    floor = 2 * stats.floor_s(stats.k2_bytes(4096), stats.k2_ops(4096))
    assert read("k2_roofline") == pytest.approx(100 * floor / 4e-6)
    assert read("device.idle_pct") == pytest.approx(60.0)
    assert read("k1_roofline") is None


def test_k1_reader_counts_the_pairs_in_the_windows():
    r = harness.layer_reader("k1_roofline")
    a = torch.zeros(8, 3)
    a[0] = torch.tensor([10.0, 50.0, 100.0])
    a[2] = 5.0
    a[3], a[4], a[5] = 0.0, 2.0, 1.0
    b = torch.zeros(8, 2)
    b[0] = torch.tensor([12.0, 90.0])
    b[3] = 1.0
    assert r.pairs_in_window(a, b) == 1  # only point 0 reaches feature 0


def test_spans_wrap_and_restore():
    import slambench.stats as target

    orig = target.rate
    s = Spans()
    s.install("slambench.stats:rate", "rate", capture=lambda a, k: a[0])
    s.timing = s.capture = True
    assert target.rate(4, 2.0) == 2.0
    assert s.count("rate") == 1 and s.captured["rate"] == [4]
    s.remove()
    assert target.rate is orig


class _Holder:
    @staticmethod
    def stat(x):
        return x + 1

    @classmethod
    def klass(cls, x):
        return (cls.__name__, x)


def test_spans_wrap_and_restore_static_and_class_methods():
    import inspect

    import numpy as np

    from pslam_tpu_torch.pipeline.system import SlamSystem

    slam = object.__new__(SlamSystem)
    targets = [("pslam_tpu_torch.pipeline.system:SlamSystem._end_read", SlamSystem, "_end_read"),
               (f"{__name__}:_Holder.stat", _Holder, "stat"),
               (f"{__name__}:_Holder.klass", _Holder, "klass")]
    raws = [inspect.getattr_static(owner, attr) for _, owner, attr in targets]
    s = Spans()
    for target, _, attr in targets:
        s.install(target, attr)
    s.timing = True
    for raw, (_, owner, attr) in zip(raws, targets):
        assert type(inspect.getattr_static(owner, attr)) is type(raw)
    np.testing.assert_array_equal(slam._end_read((torch.arange(3.0), None)), [0.0, 1.0, 2.0])
    assert _Holder().stat(1) == _Holder.stat(1) == 2
    assert _Holder().klass(3) == ("_Holder", 3)
    assert [s.count(a) for _, _, a in targets] == [1, 2, 1]
    s.remove()
    for raw, (_, owner, attr) in zip(raws, targets):
        assert inspect.getattr_static(owner, attr) is raw
    np.testing.assert_array_equal(slam._end_read((torch.ones(2), None)), [1.0, 1.0])
    assert _Holder().stat(1) == 2 and s.count("stat") == 2


def test_pipeline_readers_on_fixed_spans_and_trace():
    spans = Spans()
    spans.records["pipeline"] = [(0.0, 0.3), (1.0, 1.2), (2.0, 2.5), (3.0, 3.2)]
    spans.records["pipeline.finish"] = [(1.1, 1.2), (2.1, 2.5), (3.1, 3.2)]
    spans.records["pipeline.wait"] = [(1.1, 1.101), (2.1, 2.102), (3.1, 3.103)]
    spans.records["mapping"] = [(2.2, 2.4)]
    acts = [("a", 0, 1, 5), ("b", 0, 1, 15), ("c", 0, 1, 28), ("d", 0, 1, 45), ("e", 0, 1, 95),
            ("f", 0, 1, 41)]
    ranges = {"pipeline": [(0, 10), (20, 30)], "pipeline.finish": [(22, 30), (40, 50)],
              "mapping": [(24, 26), (42, 48)]}
    run = harness.LayerRun(spans, DeviceTrace(acts, ranges, 1e-6), {})
    read = lambda name: harness.layer_reader(name).read(run)
    assert read("pipeline.dispatch_ms_per_frame") == pytest.approx((1.2 - 0.6) / 4 * 1e3)
    assert read("pipeline.finish_ms_per_frame") == pytest.approx((0.6 - 0.2) / 3 * 1e3)
    assert read("pipeline.wait_ms_per_frame") == pytest.approx(0.006 / 3 * 1e3)
    # a (a dispatch), c (a finish inside a call) and f (the closing
    # finish()) count; b (between ranges), d (a keyframe) and e do not.
    assert read("pipeline.launches_per_frame") == 1.5
    empty = harness.LayerRun(Spans(), DeviceTrace([], {}, 1e-6), {})
    assert all(harness.layer_reader(n).read(empty) is None
               for n in ("pipeline.dispatch_ms_per_frame", "pipeline.finish_ms_per_frame",
                         "pipeline.wait_ms_per_frame", "pipeline.launches_per_frame"))
