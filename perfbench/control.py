"""Read the comparison that decides ``correct`` with something other than
the sound program in the program's place, seed after seed in one process,
on the card and at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds <s> --mode control
    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds <s> --mode half

``--mode control``: the reference itself, computed in the nearest precision
below the one the configuration states (float32 with TF32 matmuls for the
float32 training cells, float32 for the float64 Sobol' pass), takes the
program's place in the comparison. ``--mode <fault>``: the program runs with
one of perfbench/faults.py's faults planted. ``--mode program``: the sound
program. Prints one JSON line per seed with the numbers compared. Benchmark
runs never run this."""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--mode', default='control')
    args = parser.parse_args(argv)
    os.environ['ROMCOMMA_X64'] = '0'
    from perfbench import faults, run
    if args.mode in faults.FAULTS:
        faults.FAULTS[args.mode]()
    elif args.mode not in ('control', 'program'):
        raise SystemExit(f'--mode {args.mode!r}: control, program or one of {list(faults.FAULTS)}')
    for seed in (int(s) for s in args.seeds.split(',')):
        result = run.run_cell(args.workload, seed, args.seconds, False,
                              control=args.mode == 'control')
        print(json.dumps({'workload': args.workload, 'mode': args.mode, 'seed': seed,
                          'correct': result['correct'],
                          'checked': {name: c['value'] for name, c in result['checked'].items()}}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
