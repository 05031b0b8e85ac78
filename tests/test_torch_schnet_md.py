"""SchNet on the cell list's MD path (``SchNetModel.from_atomic_numbers``:
``select``, ``energy_and_forces_from_selection``, ``overflow_counts``) on
the CPU, at width 16, 8 Gaussians, 2 interactions and a 6 A cutoff (skin
0.25) on 300 waters (900 atoms: a 6.25 A cell list needs a box three cells
wide): against the benchmark's plain reference
(``mdbench/reference/schnet_cell_list.py``) on its seeded parameters,
against the O(N^2) pair-list path and the JAX package's SchNet on the same
weights, a lane of the Verlet skin contributing exactly nothing, the
parameters following the seed, and two MD blocks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdbench import harness, inputs, schnet_params
from mdbench.models import schnet_cell_list as kind
from nnpops_tpu.config import CFConvConfig as JConfig
from nnpops_tpu.models.schnet import SchNetModel as JSchNet
from nnpops_tpu_torch.config import CFConvConfig
from nnpops_tpu_torch.md import integrators
from nnpops_tpu_torch.models.schnet import SchNetModel
from nnpops_tpu_torch.ops import cfconv as cfconv_ops
from nnpops_tpu_torch.params import schnet_params_from_jax

SMALL = dict(width=16, gaussians=8, interactions=2, cutoff=6.0,
             aev_length=16, layer_dims=[[8]])
SKIN = 0.25


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell():
    cfg = harness.load_json('configs', 'schnet')
    cfg.update(SMALL)
    traffic = harness.load_json('traffic', 'water26010-check1')
    traffic['molecules'] = 300
    return cfg, traffic


@pytest.fixture(scope='module')
def cell():
    """(cfg, setup, model, cell list, params, positions) at one seed."""
    cfg, traffic = small_cell()
    setup = harness.make_setup(cfg, traffic, 2 ** 33 + 5, 'cpu')
    model, cells = kind.schnet_model(cfg, setup)
    params = kind.port_params(cfg, setup)
    r = inputs.restart(2 ** 33 + 5, 0, setup.frame, setup.masses, 0.596, 0.02)
    return cfg, setup, model, cells, params, r.positions


def test_cell_list_sizes(cell):
    cfg, setup, model, cells, _, _ = cell
    assert model.num_interactions == 2 and model.num_species == 2
    assert cells.cutoff == pytest.approx(6.25)
    assert cells.ncells == (3, 3, 3) and cells.capacity == 256
    assert model.species[:3] == (1, 0, 0)          # O, H, H


def test_equals_plain_reference(cell):
    """Energy rtol 1e-6, forces within 1e-5 of their largest (both float32
    on the CPU, the conv's backward in its plain version)."""
    cfg, setup, model, cells, params, pos = cell
    sel = model.select(pos, setup.box, cells)
    e, f = model.energy_and_forces_from_selection(params, pos, setup.box,
                                                  cells, sel)
    ref = harness.load_module(harness.HERE / 'reference'
                              / 'schnet_cell_list.py').make(cfg, setup)
    er, fr, none = ref.energy_forces_and_ani(pos)
    assert none is None and er.dtype == torch.float64
    assert float(torch.max(torch.abs(fr))) > 0.1
    np.testing.assert_allclose(float(e), float(er), rtol=1e-6)
    np.testing.assert_allclose(f.numpy(), fr.numpy(), rtol=0,
                               atol=1e-5 * float(torch.max(torch.abs(fr))))


def test_equals_pair_list_and_jax(monkeypatch):
    """The cell-list path, the O(N^2) pair-list ``energy_and_forces`` and
    the JAX package's SchNet on the same weights and positions: energy
    rtol 1e-5, forces within 1e-4 of their largest."""
    cfg, traffic = small_cell()
    frame = inputs.water_frame(traffic['molecules'], 0)
    config = dict(width=16, num_gaussians=8, cutoff=6.0,
                  gaussian_width=6.0 / 7)
    jm = JSchNet(JConfig(**config), num_species=2, num_interactions=2)
    jp = jm.init(jax.random.PRNGKey(4))
    tp = schnet_params_from_jax(jax.tree.map(np.asarray, jp), device='cpu')
    model = SchNetModel.from_atomic_numbers(
        frame.atomic_numbers, CFConvConfig(**config), [1, 8],
        num_interactions=2)
    species = np.asarray(model.species, np.int32)
    pos, box = torch.tensor(frame.positions), torch.tensor(frame.box)
    old_e, old_f = model.energy_and_forces(tp, pos, torch.tensor(species),
                                           box)
    je, jf = jax.jit(jm.energy_and_forces)(
        jp, jnp.asarray(frame.positions), jnp.asarray(species),
        jnp.asarray(frame.box))

    def refuse(*args, **kwargs):
        raise AssertionError('the MD path built the O(N^2) pair list')

    monkeypatch.setattr(cfconv_ops, 'build_cfconv_neighbors', refuse)
    cells = model.create_cell_list(frame.box, skin=SKIN)
    sel = model.select(pos, box, cells)
    e, f = model.energy_and_forces_from_selection(tp, pos, box, cells, sel)
    scale = float(torch.max(torch.abs(old_f)))
    for other_e, other_f in ((old_e, old_f), (je, jf)):
        np.testing.assert_allclose(float(e), float(other_e), rtol=1e-5)
        np.testing.assert_allclose(f.numpy(), np.asarray(other_f), rtol=0,
                                   atol=1e-4 * scale)


def test_skin_lane_contributes_nothing():
    """Two atoms selected 5.9 A apart, then one moved to 6.1 A: the lane
    stays in the frozen selection (inside 6.25 A) past the 6 A cutoff, and
    gives exactly the energy of the two atoms far apart and exactly zero
    forces; at 5.9 A the forces are not zero."""
    config = CFConvConfig(width=16, num_gaussians=8, cutoff=6.0,
                          gaussian_width=6.0 / 7)
    model = SchNetModel.from_atomic_numbers([8, 1], config, [1, 8],
                                            num_interactions=2)
    params = model.init(torch.Generator().manual_seed(2), device='cpu')
    box = torch.eye(3) * 20.0
    cells = model.create_cell_list(box, skin=SKIN)

    def at(dx):
        return torch.tensor([[2.0, 3.0, 4.0], [2.0 + dx, 3.0, 4.0]])

    sel = model.select(at(5.9), box, cells)
    assert bool(sel.mask.any(1).all())
    e_near, f_near = model.energy_and_forces_from_selection(
        params, at(5.9), box, cells, sel)
    e_skin, f_skin = model.energy_and_forces_from_selection(
        params, at(6.1), box, cells, sel)
    far = at(9.0)
    e_far, f_far = model.energy_and_forces_from_selection(
        params, far, box, cells, model.select(far, box, cells))
    assert float(torch.max(torch.abs(f_near))) > 0
    assert float(e_skin) == float(e_far)
    assert bool(torch.all(f_skin == 0)) and bool(torch.all(f_far == 0))


def test_params_follow_the_seed():
    cfg, _ = small_cell()

    def draw(seed):
        w = inputs.make_weights(seed, cfg['layer_dims'], cfg['aev_length'],
                                cfg['num_models'], cfg['bias_scale'], 'cpu')
        return schnet_params.make(cfg, w, 'cpu')

    a, b, c = draw(2 ** 33 + 1), draw(2 ** 33 + 1), draw(2 ** 33 + 2)
    assert a.blocks[1].w2.shape == (16, 16) and a.readout1_w.shape == (16, 8)
    for x, y, z in zip(a.blocks[0] + (a.embedding,),
                       b.blocks[0] + (b.embedding,),
                       c.blocks[0] + (c.embedding,)):
        assert torch.equal(x, y)
        assert not torch.any(x) or not torch.equal(x, z)
    assert not torch.equal(a.readout1_w, c.readout1_w)


def test_sticky_md_drives_the_model(cell, monkeypatch):
    """``run_md_sticky_counts`` for two 4-step blocks: finite energies and
    positions, every count within its capacity, the O(N^2) pair list never
    built."""
    cfg, setup, model, cells, params, pos = cell

    def refuse(*args, **kwargs):
        raise AssertionError('the MD path built the O(N^2) pair list')

    monkeypatch.setattr(cfconv_ops, 'build_cfconv_neighbors', refuse)
    i = cfg['integrator']
    r = inputs.restart(3, 0, setup.frame, setup.masses, i['kT'], 0.02)
    zeros = torch.zeros_like(pos)
    state = integrators.MDState(r.positions, r.velocities, zeros,
                                zeros.new_zeros(()), r.generator,
                                torch.zeros((), dtype=torch.int32))
    box = setup.box
    state, energies, stats = integrators.run_md_sticky_counts(
        lambda p: model.select(p, box, cells),
        lambda sel, p: model.energy_and_forces_from_selection(
            params, p, box, cells, sel),
        lambda fn: integrators.langevin_baoab(fn, setup.masses, i['dt'],
                                              i['friction'], i['kT']),
        state, 8, 4, lambda sel, p: model.overflow_counts(p, box, cells, sel))
    assert energies.shape == (2,) and bool(torch.isfinite(energies).all())
    assert bool(torch.isfinite(state.positions).all())
    caps = model.capacities(cells)
    assert set(stats) == set(caps)
    for k, v in stats.items():
        assert 0 < int(v) <= caps[k], k
