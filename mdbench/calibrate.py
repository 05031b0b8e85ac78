"""Readings the correctness limits are set from, on the card, in one
process: the program's gaps over many seeds (short windows of the cell's
own traffic, the cell's own sizes) and the control's, the reference
computed one precision step lower and put in the program's place; with
``--ensemble-control-seeds``, also the control that lowers the ensemble's
operands alone.

    python3 mdbench/calibrate.py --config <name> --traffic <name> \
        --seconds 3 --seeds 11 12 ... --control-seeds 21 22 23

A configuration and a traffic mix are named, not a cell, so a cell can be
calibrated before ``BENCHMARK.json`` lists it. Prints one JSON line per
(side, seed): the gaps of ``reference/md.py`` that the configuration's
limits name. The program is built once; each seed's weights are copied
into its weight tensors in place.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--traffic', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--ensemble-control-seeds', type=int, nargs='*',
                    default=[])
    args = ap.parse_args(argv)
    import torch
    from mdbench import harness, inputs
    cfg = harness.load_json('configs', args.config)
    traffic = harness.load_json('traffic', args.traffic)
    if not torch.cuda.is_available():
        log('no CUDA card')
        return 3
    controls = ([(s, True) for s in args.control_seeds]
                + [(s, 'ensemble') for s in args.ensemble_control_seeds])
    seeds = args.seeds + [s for s, _ in controls]
    setup = harness.make_setup(cfg, traffic, seeds[0], 'cuda')
    kind = cfg['kind']
    system = harness.load_module(harness.HERE / 'models' / f'{kind}.py'
                                 ).build(cfg, setup)
    ref_mod = harness.load_module(harness.HERE / 'reference' / f'{kind}.py')

    def use_weights(seed):
        new = inputs.make_weights(seed, cfg['layer_dims'], cfg['aev_length'],
                                  cfg['num_models'], cfg['bias_scale'],
                                  setup.device)
        with torch.no_grad():
            for old, fresh in zip(setup.weights, new):
                for a, b in zip(old.weights + old.biases,
                                fresh.weights + fresh.biases):
                    a.copy_(b)

    for seed in args.seeds:
        use_weights(seed)
        t0 = time.perf_counter()
        runner = harness.Runner(system, setup, cfg, traffic, seed,
                                int(traffic['check_segments']))
        fns = harness.wrapped(system)
        runner.block(fns)
        runner.new_segment()
        runner.recording = True
        start = time.perf_counter()
        n = failed = 0
        while time.perf_counter() - start < args.seconds or n == 0:
            failed += not runner.block(fns)[1]
            n += 1
        runner.recording = False
        runner.close()
        numbers = harness.compare(ref_mod.make(cfg, setup), cfg, traffic,
                                  setup, seed, runner.kept, log)
        print(json.dumps({'side': 'program', 'seed': seed, 'blocks': n,
                          'failed': failed, **numbers,
                          'seconds': time.perf_counter() - t0}), flush=True)
    for seed, control in controls:
        use_weights(seed)
        t0 = time.perf_counter()
        numbers = harness.control_gaps(ref_mod.make(cfg, setup), cfg,
                                       traffic, setup, seed, control)
        side = 'control' if control is True else f'control_{control}'
        print(json.dumps({'side': side, 'seed': seed, **numbers,
                          'seconds': time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
