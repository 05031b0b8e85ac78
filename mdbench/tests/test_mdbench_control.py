"""The control, the reference computed one precision step lower (AEV and
PME in bfloat16, the ensemble's operands in float8 e4m3) and put in the
program's place, reads over the configuration's limits, and so does the
control that lowers the ensemble's operands alone; a sound run of the
program reads under them. At 150 waters on the CPU; on the card at
the cells' own sizes, ``mdbench/calibrate.py`` reads both (PERF.md)."""
import pytest
import torch

from mdbench import harness
from helpers import run_small, small_cell


def _control_numbers(config, seed, control):
    cfg, tr = small_cell(config)
    setup = harness.make_setup(cfg, tr, seed, 'cpu')
    ref = harness.load_module(harness.HERE / 'reference'
                              / f'{cfg["kind"]}.py').make(cfg, setup)
    return cfg, harness.control_gaps(ref, cfg, tr, setup, seed, control)


@pytest.mark.parametrize('control', [True, 'ensemble'])
@pytest.mark.parametrize('config', ['ani2x', 'ani2x_pme'])
@pytest.mark.parametrize('seed', [11, 2 ** 33 + 12, 13])
def test_control_fails(config, seed, control):
    cfg, numbers = _control_numbers(config, seed, control)
    correct, _ = harness.verdict(cfg, {'failed': 0, 'numbers': numbers})
    assert not correct, numbers


@pytest.mark.parametrize('config', ['ani2x', 'ani2x_pme'])
def test_sound_run_is_correct(config):
    cfg, tr = small_cell(config)
    out = run_small(cfg, tr, 2 ** 33 + 21)
    correct, checks = harness.verdict(cfg, out)
    assert correct, checks
    assert out['attempted'] >= 1 and out['failed'] == 0


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the smallest cell on the card, correct."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import time
    cfg = harness.load_json('configs', 'ani2x')
    tr = harness.load_json('traffic', 'water2601')
    out = harness.run_cell(cfg, tr, 2 ** 33 + 31, 2.0, False, 'cuda',
                           time.perf_counter(), log=lambda *a: None)
    correct, checks = harness.verdict(cfg, out)
    assert correct, checks
