"""The check's readings on the card: a cell's timed path run over
several seeds at one or more render qualities, each with a short window,
in one process. Quality 9 (bf16 accumulators) is the control, which the
limits in ``limits/<cell>.json`` have to refuse; quality 10 gives the
readings of sound runs.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 \
        --quality 10,9 --seconds 3

One JSON line a run: the cell, seed, quality, frames and the compared
numbers."""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from gpubench import cells, core  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--quality', default='10,9')
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    cell = cells.cell(args.workload)
    for quality in [int(q) for q in args.quality.split(',')]:
        for seed in [int(s) for s in args.seeds.split(',')]:
            r = core.run_cell(cell, seed, args.seconds, False,
                              core.cell_devices(cell, args.device),
                              time.perf_counter(), quality=quality)
            print(json.dumps({'cell': args.workload, 'seed': seed,
                              'quality': quality,
                              'frames': r['attempted'],
                              'correct': r['correct'],
                              'checks': r['checks']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
