"""Every configuration, traffic mix, model kind and metric that
BENCHMARK.json names resolves to its file, and the file agrees with it."""
import json
import re

import pytest

from mdbench import harness
from mdbench.reference import md as ref_md

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def test_configs_resolve():
    for c in BENCH['configs']:
        assert NAME.match(c['name'])
        cfg = json.loads((ROOT / c['file']).read_text())
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced']
        for sub in ('models', 'reference'):
            assert (harness.HERE / sub / f'{cfg["kind"]}.py').is_file()
        assert {'energy_gap', 'force_gap', 'velocity_gap'} <= set(
            cfg['limits']) <= set(ref_md.NUMBERS)


def test_workloads_resolve():
    configs = {c['name'] for c in BENCH['configs']}
    used = set()
    for w in BENCH['workloads']:
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['config'] in configs and w['chips'] in (1, 4)
        tr = harness.load_json('traffic', w['traffic'])
        assert tr['name'] == w['traffic']
        assert tr['segment_steps'] % int(tr.get('refresh', harness.load_json(
            'configs', w['config'])['refresh'])) == 0
        used.add(w['config'])
        assert 1 <= len(w['why']) <= 200
    assert used == configs


@pytest.mark.parametrize('metric', BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_readers_resolve(metric):
    module = harness.load_module(harness.HERE / 'metrics'
                                 / f'{metric["name"]}.py')
    assert callable(module.read)
    assert metric['moves'] in {m['name'] for m in BENCH['end_to_end']}


def test_readers_find_nothing_in_an_empty_trace():
    """A reader that finds nothing returns None, never 0."""
    from types import SimpleNamespace
    ctx = SimpleNamespace(spans={}, trace={}, trace_steps=0,
                          least_force_s=None, step_ms=None, work={},
                          counts={})
    for m in BENCH['per_layer']:
        module = harness.load_module(harness.HERE / 'metrics'
                                     / f'{m["name"]}.py')
        assert module.read(ctx) is None
