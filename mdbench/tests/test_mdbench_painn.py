"""The ``painn_cell_list`` kind at a small size on the CPU (width 16, 8
radial functions, 2 blocks, a 5 A cutoff, 300 waters: a 5.25 A cell list
needs a box three cells wide): a sound run of the program through the
harness reads under the configuration's limits; the control, the
reference with the operands of its filter product and of phi's dense
layers in bfloat16, reads over them on every seed; the work counts against
hand arithmetic; the reference and the parameters import nothing of the
program."""
import json
import subprocess
import sys

import pytest
import torch

from mdbench import harness
from helpers import run_small, small_cell

SMALL = dict(width=16, radial=8, interactions=2, cutoff=5.0, aev_length=16,
             layer_dims=[[8]])


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def painn_cell():
    cfg, tr = small_cell('painn', 'water26010-check1')
    cfg.update(SMALL)
    tr['molecules'] = 300
    return cfg, tr


def reference(cfg, tr, seed):
    setup = harness.make_setup(cfg, tr, seed, 'cpu')
    return setup, harness.load_module(
        harness.HERE / 'reference' / 'painn_cell_list.py').make(cfg, setup)


def test_sound_run_is_correct():
    cfg, tr = painn_cell()
    out = run_small(cfg, tr, 2 ** 33 + 21)
    correct, checks = harness.verdict(cfg, out)
    assert correct, checks
    assert out['attempted'] >= 1 and out['failed'] == 0


@pytest.mark.parametrize('seed', [11, 2 ** 33 + 12, 13])
def test_control_fails(seed):
    cfg, tr = painn_cell()
    setup, ref = reference(cfg, tr, seed)
    numbers = harness.control_gaps(ref, cfg, tr, setup, seed)
    correct, _ = harness.verdict(cfg, {'failed': 0, 'numbers': numbers})
    assert not correct, numbers


def test_work_counts():
    cfg, tr = painn_cell()
    setup, ref = reference(cfg, tr, 5)
    counts = ref.work_counts(setup.frame)
    assert counts['atoms'] == 900 and counts['species'] == 2
    assert counts['radial'] == 8 and counts['interactions'] == 2
    # About 52 neighbors inside 5 A at liquid density.
    assert 45 * 900 < counts['painn_pairs'] < 60 * 900
    w = ref.work(cfg, dict(counts, painn_pairs=1000, atoms=10))
    # Per pair and block: the filter product (8 x 48) and its adjoint, 2
    # FLOP an FMA; per atom and block: 15 F^2 multiply-adds forward and
    # back; the readout 16 -> 8 -> 1.
    atom = 4 * (16 * 16 + 16 * 48 + 3 * 16 * 32 + 32 * 16 + 16 * 48)
    assert atom == 4 * 15 * 16 * 16
    assert w['tensor_bf16'] == 2 * (1000 * 4 * 8 * 48 + 10 * atom) \
        + 10 * 4 * (16 * 8 + 8)
    assert w['fp32'] == 2 * 1000 * ((22 + 46) * 16 + 4 * 8)
    assert w['sfu'] == 2 * 1000 * (2 * 8 + 3)
    params = (2 * 16 + 2 * (16 * 16 + 16 + 16 * 48 + 48 + 8 * 48 + 48
                            + 16 * 32 + 32 * 16 + 16 + 16 * 48 + 48)
              + 16 * 8 + 8 + 8 + 1)
    assert w['bytes'] == 4 * params + 10 * 28 + 4


SCRIPT = f'''
import json, sys
sys.path.insert(0, {str(harness.HERE.parent)!r})
sys.path.insert(0, {str(harness.HERE / 'tests')!r})
from test_mdbench_painn import painn_cell, reference
cfg, tr = painn_cell()
setup, ref = reference(cfg, tr, 7)
energy, forces, _ = ref.energy_forces_and_ani(setup.frame)
print(json.dumps([float(energy),
                  sorted({{m.split('.')[0] for m in sys.modules}})]))
'''


def test_reference_imports_nothing_of_the_program():
    proc = subprocess.run([sys.executable, '-c', SCRIPT], capture_output=True,
                          text=True, timeout=600, cwd=str(harness.HERE))
    assert proc.returncode == 0, proc.stderr[-3000:]
    energy, top = json.loads(proc.stdout.strip().splitlines()[-1])
    assert energy == energy
    assert not set(top) & {'nnpops_tpu_torch', 'nnpops_tpu', 'jax',
                           'jaxlib', 'flax'}
