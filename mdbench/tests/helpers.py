"""Small cells for the CPU tests: a cell's configuration and traffic with
the box cut to 150 waters (the window path needs three cells a side) and
8-step segments."""
import time

from mdbench import harness

MOLECULES = 150


def small_cell(config: str, traffic: str = 'water2601', refresh: int = 4,
               segment_steps: int = 8):
    cfg = harness.load_json('configs', config)
    cfg['refresh'] = refresh
    tr = harness.load_json('traffic', traffic)
    tr.update(molecules=MOLECULES, segment_steps=segment_steps,
              warm_blocks=1, check_segments=1)
    return cfg, tr


def run_small(cfg, tr, seed, seconds=0.5, trace=False, per_layer=()):
    return harness.run_cell(cfg, tr, seed, seconds, trace, 'cpu',
                            time.perf_counter(), per_layer=per_layer,
                            log=lambda *a: None)
