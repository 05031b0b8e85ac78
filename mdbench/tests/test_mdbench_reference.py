"""The plain reference against the port's CPU path on a 150-water box.

The port runs its float32 path (``nn_impl='xla'``, no bf16) here, so the
two agree to float32 rounding; the card's cells run the bf16 fused
ensemble, whose gap the limits allow for."""
import numpy as np
import pytest
import torch

from mdbench import harness, inputs
from helpers import MOLECULES


def _pair(config):
    cfg = harness.load_json('configs', config)
    cfg.update(nn_dtype=None, nn_impl='xla')
    tr = harness.load_json('traffic', 'water2601')
    tr['molecules'] = MOLECULES
    setup = harness.make_setup(cfg, tr, 2 ** 33 + 17, 'cpu')
    kind = cfg['kind']
    system = harness.load_module(harness.HERE / 'models' / f'{kind}.py'
                                 ).build(cfg, setup)
    ref = harness.load_module(harness.HERE / 'reference' / f'{kind}.py'
                              ).make(cfg, setup)
    return cfg, setup, system, ref


@pytest.mark.parametrize('config', ['ani2x', 'ani2x_pme'])
def test_reference_matches_port(config):
    cfg, setup, system, ref = _pair(config)
    r = inputs.restart(5, 0, setup.frame, setup.masses, 0.596, 0.02)
    e_p, f_p = system.force(system.select(r.positions), r.positions)
    e_r, f_r = ref.energy_and_forces(r.positions)
    n = len(f_r)
    assert abs(float(e_p) - float(e_r)) / n < 5e-6
    assert float(torch.max(torch.abs(f_p - f_r)) / torch.max(torch.abs(f_r))
                 ) < 1e-5


def test_reciprocal_force_on_a_grid_point():
    """An atom exactly on a grid point: the reference's PME reciprocal
    force equals the port's and is continuous there."""
    from nnpops_tpu_torch.ops.pme import PME, pme_reciprocal_energy
    cfg, setup, system, ref = _pair('ani2x_pme')
    n = len(setup.atomic_numbers)
    pme = PME(*setup.pme_grid, 5, 0.6, 1389.35457,
              np.full((n, 1), -1, np.int32), device='cpu')
    edge, grid = float(setup.box[0, 0]), setup.pme_grid[0]

    def forces(eps):
        x = setup.frame.clone()
        x[7, 1] = (11.0 + eps) * edge / grid
        out = []
        for fn in (lambda xx: pme_reciprocal_energy(
                       xx, setup.charges, setup.box, pme.config, pme.moduli),
                   lambda xx: ref._reciprocal(xx, torch.float32)):
            xx = x.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(fn(xx), xx)
            out.append(-g[7])
        return out

    port, reference = forces(0.0)
    assert torch.allclose(port, reference, rtol=1e-4, atol=1e-4)
    below, above = forces(-1e-4)[1], forces(1e-4)[1]
    assert torch.allclose(reference, 0.5 * (below + above), atol=1e-3)


@pytest.mark.parametrize('shift', [0.01, 0.2, 2.0])
def test_pair_list_is_the_brute_force_search(shift):
    """The Verlet list gives the pairs a fresh brute-force search gives,
    for moves inside its skin and past it."""
    from mdbench.reference.md import PairList, box_lengths, pairs_within
    frame = inputs.water_frame(MOLECULES, 3)
    pos = torch.tensor(frame.positions)
    lengths = box_lengths(torch.tensor(frame.box))
    pairs = PairList(lengths, 5.1)
    pairs(pos)
    gen = torch.Generator().manual_seed(7)
    moved = pos + shift * (2 * torch.rand(pos.shape, generator=gen) - 1)
    for got, want in zip(pairs(moved), pairs_within(moved, lengths, 5.1)):
        assert torch.equal(got, want)


def test_frame_is_the_ports_water_box():
    from nnpops_tpu_torch.utils import make_water_box
    frame = inputs.water_frame(MOLECULES, 3)
    port = make_water_box(MOLECULES, seed=3)
    np.testing.assert_array_equal(frame.positions, port.positions)
    np.testing.assert_array_equal(frame.box, port.box)
    np.testing.assert_array_equal(frame.atomic_numbers, port.atomic_numbers)


def test_inputs_follow_the_seed():
    """The same seed gives the same inputs, another seed others; seeds past
    32 bits work."""
    big = 2 ** 33 + 5
    a = inputs.make_weights(big, [[8, 4]], 16, 2, 0.1, 'cpu')
    b = inputs.make_weights(big, [[8, 4]], 16, 2, 0.1, 'cpu')
    c = inputs.make_weights(big + 1, [[8, 4]], 16, 2, 0.1, 'cpu')
    assert torch.equal(a[0].weights[0], b[0].weights[0])
    assert not torch.equal(a[0].weights[0], c[0].weights[0])
    w = a[0].weights[0]
    assert torch.equal(w, w.to(torch.bfloat16).float())
