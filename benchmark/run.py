"""One run of one benchmark cell of the PyTorch + CUDA port (cbird_tpu_torch).

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  The cell is the entry NAME of
``workloads`` in ``BENCHMARK.json``; its configuration, traffic mix,
check settings and metric readers are found by name under
``benchmark/`` (``benchlib/manifest.py``).  The run makes its data from
the seed, fills the index through its own load path, warms up, then
measures for S seconds (``--trace 1``: traces a window instead and reads
the per-layer metrics), checks a seeded sample of the window's answers
against the plain reference (``benchmark/reference/``) and prints one
JSON line as its last line of standard output.

The process runs its host work on one thread: the numeric libraries'
thread pools are set to one before they load, so a run's host time does
not hang on how many of the machine's cores are free.

Exits 2 without a result when CUDA is absent or has fewer devices than
the cell asks for, and 3 when a JAX module was loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402

for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_pool] = "1"

import argparse  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    from benchlib import cell
    return cell.main(args, ROOT, T0)


if __name__ == "__main__":
    sys.exit(main())
