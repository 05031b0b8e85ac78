"""The essential-work counts against hand arithmetic."""
import pytest

from mdbench import harness, work


def test_water_macs_per_model():
    cfg = harness.load_json('configs', 'ani2x')
    h = work.network_macs(1008, cfg['layer_dims'][0])
    o = work.network_macs(1008, cfg['layer_dims'][3])
    assert h == 1008 * 256 + 256 * 192 + 192 * 160 + 160
    assert o == 1008 * 192 + 192 * 160 + 160 * 128 + 128
    assert 2 * h + o == 921_024


def test_ensemble_least_time_at_26k():
    cfg = harness.load_json('configs', 'ani2x')
    w = work.ani_work(cfg, {'atoms_per_species': [17340, 0, 0, 8670, 0, 0, 0],
                            'radial_pairs': 0, 'angular_triples': 0})
    # 8,670 waters x 921,024 MACs x 8 models x 2 FLOP x 2 passes.
    assert w['tensor_bf16'] == 8670 * 921_024 * 8 * 4
    assert work.least_time(w) == pytest.approx(255.5289e9 / 989e12, rel=1e-6)


def test_least_time_is_the_slowest_class():
    w = {'tensor_bf16': 989e12, 'fp32': 67e12 * 2, 'sfu': 0, 'bytes': 0}
    assert work.least_time(w) == pytest.approx(2.0)


def test_pme_work():
    counts = {'pme_atoms': 10, 'pme_order': 5, 'pme_grid': [16, 16, 16],
              'pme_pairs': 100}
    w = work.pme_work(counts)
    points = 16 ** 3
    fft = 2 * 5 * points * 12 + 10 * points
    per_atom = 6 * 25 + 125 * 15
    assert w['fp32'] == pytest.approx(100 * 76 + 10 * per_atom + fft)
    assert w['sfu'] == 600
