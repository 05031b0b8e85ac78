"""The ``mace_cell_list`` kind at a small size on the CPU (8 channels, every
other width MACE-OFF23 medium's, 300 waters: a 5.25 A cell list needs a
box three cells wide): a sound run of the program through the harness
reads under the configuration's limits; the control, the reference with
the operands of its radial MLPs and of its up linears in bfloat16, reads
over them on every seed; the work counts against hand arithmetic; the
reference and the parameters import nothing of the program."""
import json
import subprocess
import sys

import pytest
import torch

from mdbench import harness
from helpers import run_small, small_cell

SMALL = dict(channels=8, aev_length=8, layer_dims=[[8]])


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mace_cell():
    cfg, tr = small_cell('mace', 'water26010-check1')
    cfg.update(SMALL)
    tr['molecules'] = 300
    return cfg, tr


def reference(cfg, tr, seed):
    setup = harness.make_setup(cfg, tr, seed, 'cpu')
    return setup, harness.load_module(
        harness.HERE / 'reference' / 'mace_cell_list.py').make(cfg, setup)


def test_sound_run_is_correct():
    cfg, tr = mace_cell()
    out = run_small(cfg, tr, 2 ** 33 + 21)
    correct, checks = harness.verdict(cfg, out)
    assert correct, checks
    assert out['attempted'] >= 1 and out['failed'] == 0


@pytest.mark.parametrize('seed', [11, 2 ** 33 + 12, 13])
def test_control_fails(seed):
    cfg, tr = mace_cell()
    setup, ref = reference(cfg, tr, seed)
    numbers = harness.control_gaps(ref, cfg, tr, setup, seed)
    correct, _ = harness.verdict(cfg, {'failed': 0, 'numbers': numbers})
    assert not correct, numbers


def test_work_counts():
    """The pairs inside 5 A by brute force, and the classes of a made-up
    count by hand: per pair the radial MLPs (4 FLOP a multiply-add:
    forward and input-side backward) and the paths' message arithmetic,
    per atom the nested contraction (4 M (16^3 + 16^2 + 16) FLOP a
    channel) and the linears."""
    cfg, tr = mace_cell()
    setup, ref = reference(cfg, tr, 5)
    counts = ref.work_counts(setup.frame)
    assert counts['atoms'] == 900 and counts['species'] == 10
    assert counts['layers'] == [[[0], [0, 1]], [[0, 1], [0]]]
    # About 55 neighbors inside 5 A at liquid density.
    assert 45 * 900 < counts['mace_pairs'] < 62 * 900
    w = ref.work(cfg, dict(counts, mace_pairs=1000, atoms=10))
    mlp = 1000 * 4 * ((8 * 64 + 2 * 64 * 64 + 64 * 4 * 8)
                      + (8 * 64 + 2 * 64 * 64 + 64 * 10 * 8))
    # Per pair, the 4 paths from 0e: 288 forward, 960 backward; the 6 from
    # 1o: 1,296 and 3,936.
    paths = 1000 * (1248 + 1248 + 5232)
    contraction = 10 * 8 * 4 * (4 + 1) * (16 ** 3 + 16 ** 2 + 16)
    linears = 10 * 4 * (64 * (1 + 1 + 4) + 64 * 16
                        + 64 * (1 + 4 + 1) + 64 * 40 + 8 * 16 + 8)
    assert w['fp32'] == mlp + paths + contraction + linears == 113200320
    assert w['sfu'] == 2 * 1000 * 2 * 192 + 1000 * (2 * 8 + 1)
    assert w['bytes'] > 4 * (2 * 10 * 8 * 8)


SCRIPT = f'''
import json, sys
sys.path.insert(0, {str(harness.HERE.parent)!r})
sys.path.insert(0, {str(harness.HERE / 'tests')!r})
from test_mdbench_mace import mace_cell, reference
cfg, tr = mace_cell()
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
