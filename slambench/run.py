"""Run one cell of the benchmark once and print its result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result object; the numbers
compared with their limits are the last lines of standard error. With
``--control 1`` the control (the reference computed in TF32 in the
program's place) is judged instead of the program and decides ``correct``;
the program's verdict goes on an earlier line.

Exit codes: 0 with a result; 2 without one (no CUDA, too few cards, no
``BENCHMARK.json`` or no port beside it); 3 without one when JAX or the JAX
package was loaded.
"""

import os
import sys
import time

_T0 = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (from /proc where there is one,
    else since this file began to run)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def main(argv=None) -> int:
    # One process, few threads, one core: the host work is single-threaded
    # Python and small numpy arrays, and runs that could move between cores
    # spread their frame rate five times wider (20% against 4%, four runs
    # each on one H100 machine).
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

    import argparse
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Caches of the program stay inside the checkout, at fixed paths.
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")

    from slambench.harness import NoResult, run

    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                     process_age=process_age, control=bool(args.control))
    except NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3 if "JAX" in str(e) else 2
    except ImportError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
