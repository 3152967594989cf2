"""The benchmark of ``egtr_tpu_torch`` on NVIDIA H100 cards: one run of one
cell.

    python3 -m portbench.run --workload vg-serve-b1 --seed 7 --seconds 10 \
        --trace 0

prints set-up parts, the window and the compared numbers on standard error
and the result as one JSON line, the last of standard output (``--trace 0``:
the cell's end-to-end metrics; ``--trace 1``: its per-layer metrics, read
from a profiled slice at the end of the window). It runs on the card only:
without CUDA, or with fewer cards than the cell asks for, it exits with a
code other than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock, from its start
    time in /proc (10 ms resolution); now where /proc is not there."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import harness

    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
