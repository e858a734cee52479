"""Time the single-device solvers of two or more trees of the port on one
NVIDIA GPU.

    python3 scripts/solver_times.py ROOT [ROOT ...]

Each ROOT holds a ``pslam_tpu_torch`` package (this checkout is ``.``; a
parent commit unpacked under ``build/`` is another). Each runs in its own
process, with its package first on ``sys.path``, in the order given: pass
``parent change change parent`` to compare two trees in one call. A process
builds ``chip_smoke.py`` phase 17's inputs (tests/test_parallel.py's
problems) on the card and times ``local_bundle_adjustment``,
``local_bundle_adjustment_lil`` and ``optimize_essential_graph``: median and
range of 10 calls after 2 warm-ups, host clock with the card synchronized
around each call. It prints one line per root, and as the last line one
JSON object with every root's times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _child(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    sys.path.insert(1, str(REPO))
    import numpy as np
    import torch

    import chip_smoke
    import pslam_tpu_torch
    from pslam_tpu_torch.solver.ba_lil import local_bundle_adjustment_lil
    from pslam_tpu_torch.solver.local_ba import local_bundle_adjustment
    from pslam_tpu_torch.solver.sim3_graph import optimize_essential_graph

    assert Path(pslam_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve())
    cam, n_free, prob, lil_state, lil_valid, ledges, graph = chip_smoke._solver_inputs("cuda")
    calls = {
        "point BA": lambda: local_bundle_adjustment(cam, prob, n_free),
        "LIL BA": lambda: local_bundle_adjustment_lil(cam, prob, lil_state, lil_valid, ledges,
                                                      n_free),
        "essential graph": lambda: optimize_essential_graph(graph, n_iters=20),
    }
    out = {}
    for name, fn in calls.items():
        ms = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 2:
                ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(median=float(np.median(ms)), min=min(ms), max=max(ms))
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(_child(argv[1])))
        return 0
    if not argv or any(a.startswith("-") for a in argv):
        raise SystemExit(__doc__)
    results = []
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--child", root], cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{root}: " + "; ".join(
            f"{k} {v['median']:.2f} ms ({v['min']:.2f}-{v['max']:.2f})" for k, v in times.items()))
        results.append(dict(root=root, **times))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
