"""The ``schnet_cell_list`` kind at a small size on the CPU (width 16, 8
Gaussians, 2 interactions, a 6 A cutoff, 300 waters: a 6.25 A cell list
needs a box three cells wide): the control, the reference with its filter
products' operands in bfloat16, reads over the configuration's limits on
every seed; a sound run of the program reads under them; the work counts
and ``cfconv_bwd_roofline`` against hand arithmetic on a synthetic trace;
the reference and the parameters import nothing of the program."""
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from mdbench import harness, work
from helpers import run_small, small_cell

SMALL = dict(width=16, gaussians=8, interactions=2, cutoff=6.0,
             aev_length=16, layer_dims=[[8]])


def schnet_cell():
    cfg, tr = small_cell('schnet', 'water26010-check1')
    cfg.update(SMALL)
    tr['molecules'] = 300
    return cfg, tr


def reference(cfg, tr, seed):
    setup = harness.make_setup(cfg, tr, seed, 'cpu')
    return setup, harness.load_module(
        harness.HERE / 'reference' / 'schnet_cell_list.py').make(cfg, setup)


@pytest.mark.parametrize('seed', [11, 2 ** 33 + 12, 13])
def test_control_fails(seed):
    cfg, tr = schnet_cell()
    setup, ref = reference(cfg, tr, seed)
    numbers = harness.control_gaps(ref, cfg, tr, setup, seed)
    correct, _ = harness.verdict(cfg, {'failed': 0, 'numbers': numbers})
    assert not correct, numbers


def test_sound_run_is_correct():
    cfg, tr = schnet_cell()
    out = run_small(cfg, tr, 2 ** 33 + 21)
    correct, checks = harness.verdict(cfg, out)
    assert correct, checks
    assert out['attempted'] >= 1 and out['failed'] == 0


def test_work_counts():
    cfg, tr = schnet_cell()
    setup, ref = reference(cfg, tr, 5)
    counts = ref.work_counts(setup.frame)
    assert counts['atoms'] == 900 and counts['species'] == 2
    # About 90 neighbors inside 6 A at liquid density.
    assert 80 * 900 < counts['cfconv_pairs'] < 100 * 900
    c = dict(counts, cfconv_pairs=1000, atoms=10)
    w = ref.work(cfg, c)
    # Per pair and layer: 2 products forward, 2 adjoint, 2 FLOP an FMA.
    pair = 4 * (8 * 16 + 16 * 16)
    atom = 4 * 3 * 16 * 16
    assert w['tensor_bf16'] == 2 * (1000 * pair + 10 * atom) \
        + 10 * 4 * (16 * 8 + 8)
    assert w['sfu'] == 2 * 1000 * (8 + 16 + 1)
    assert w['fp32'] == 2 * 1000 * 6 * 16


def read_roofline(counts, trace):
    from mdbench.metrics import cfconv_bwd_roofline
    return cfconv_bwd_roofline.read(SimpleNamespace(counts=counts,
                                                    trace=trace))


def test_cfconv_bwd_roofline_on_a_synthetic_trace():
    """Six layers of 10.9 M pairs at W 128, G 50: 91,136 FLOP a pair, 5.96
    TFLOP, 6.03 ms at 989 TFLOP/s; B.6 (both kernels) 0.8 s over 10 force
    spans is 80 ms a call: 7.5 %."""
    counts = {'cfconv_pairs': 10_900_000, 'interactions': 6, 'width': 128,
              'gaussians': 50, 'atoms': 26010, 'species': 2}
    trace = {'span_device': {'force': (3.5, 10)},
             'breakdown': {'device_ops': [
                 ['anon::cfconv_bwd_kernel<128, false>', 0.79],
                 ['at::native::elementwise', 2.0],
                 ['anon::cfconv_bwd_reduce', 0.01]]}}
    least = 6 * 10_900_000 * 91_136 / 989e12
    assert read_roofline(counts, trace) == pytest.approx(
        100 * least / 0.08)
    assert read_roofline(counts, trace) == pytest.approx(7.5335, rel=1e-4)
    # B.6 absent, no force span, or an ANI cell's counts: no reading.
    none = dict(trace, breakdown={'device_ops': [['ens_gemm', 1.0]]})
    assert read_roofline(counts, none) is None
    assert read_roofline(counts, dict(trace, span_device={})) is None
    assert read_roofline({'radial_pairs': 5}, trace) is None
    assert work.PEAKS['bf16_tensor_flops'] == 989e12


SCRIPT = f'''
import json, sys
sys.path.insert(0, {str(harness.HERE.parent)!r})
sys.path.insert(0, {str(harness.HERE / 'tests')!r})
from test_mdbench_schnet import reference, schnet_cell
cfg, tr = schnet_cell()
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
