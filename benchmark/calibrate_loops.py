"""Readings that set the limits of `correct` in the cells whose loop
carries its own readings (a loop module's `readings`: loops/epdn_closed.py,
loops/infer_closed_all.py), several seeds in one process, as
calibrate.py takes them for the other loops (not run by the benchmark's
own runs):

    python3 -m benchmark.calibrate_loops --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--window 8] [--out readings.jsonl]

The options, the lines printed and the summary are calibrate.py's,
whose `main` this runs with its readings taken from the cell's loop.
"""

from __future__ import annotations

import sys

from . import calibrate


def loop_readings(cell, seed, device, controls, window, ties):
    return cell.loop().readings(cell, seed, device, controls, window)


def main(argv=None):
    # calibrate.main takes train_closed's readings by the loop's name and
    # infer_closed's for any other loop: those become the loop's own
    calibrate.infer_readings = loop_readings
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
