"""The local_ba.graph_share reader on fixed counters."""

import pytest

from slambench import harness
from slambench.trace import Spans


def test_graph_share_reads_the_replays_over_the_bas():
    read = harness.layer_reader("local_ba.graph_share").read
    spans = Spans()
    # A program that counts no replays (one without the BA graphs) reads
    # nothing; so does a window without a BA.
    assert read(harness.LayerRun(spans, None, {"ba_runs": 20})) is None
    assert read(harness.LayerRun(spans, None, {"ba_runs": 0, "ba_graph_replays": 0})) is None
    run = harness.LayerRun(spans, None, {"ba_runs": 20, "ba_graph_replays": 18,
                                         "ba_graph_captures": 1})
    assert read(run) == pytest.approx(0.9)
