"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``): import torch with one thread to each of the
libraries' pools, initialise CUDA, build or load the configuration's CUDA
kernels in ``build/kernels/`` of the checkout, make the cell's pool of event
lists from ``--seed`` with the benchmark's generator (``.npz`` files under
``TMPDIR``), and run one warm-up job on a list of its own that holds the
chunk sizes of a job. The window then runs jobs back to back, each
``Simulation(<list>.npz, ...).run()`` of the port on the card, starting one
only while fewer than ``--seconds`` have passed; ``events_per_s`` is all
input events of those jobs over the time from the window's start to the
last job's end. ``--trace 1`` runs the same window with the benchmark's
wrapper spans, profiles one job of it and reports the per-layer metrics.
After the window one job, drawn from the seed, is compared with the
reference (``portbench/reference``); the numbers compared and their limits
are the last lines on standard error and the ``checks`` of the result, the
last line on standard output."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


# the thread pools of OpenMP, the BLAS libraries and torch's intra-op pool
# take one thread each, so that their spinning workers leave the host's
# cores to the one thread that launches the card's work
HOST_THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def steady_host():
    """Set the thread counts before numpy or torch is imported."""
    os.environ.update(HOST_THREADS)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    steady_host()
    from portbench import harness
    sys.exit(harness.run(args, t_start=T_START))
