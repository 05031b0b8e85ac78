"""The port's ANI + PME force field (``models.combined.ANIWithPME``) against
the JAX package's on water(150): window ANI-2x (a small ensemble, params
carried across with ``params.from_jax_params``) and PME 16^3, alpha 0.6,
cutoff 5.0. The plan, the force step at the window slice's gates, the
overflow counts exactly, and a finite-difference check along F."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.models.combined import ANIWithPME as JANIWithPME
from nnpops_tpu.ops.pme import PME as JPME
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.models.ani import ANIModel
from nnpops_tpu_torch.models.combined import (ANIWithPME, config5,
                                              plain_energy_and_forces)
from nnpops_tpu_torch.ops.pme import PME
from nnpops_tpu_torch.params import from_jax_params
from nnpops_tpu_torch.utils import make_water_box

SKIN = 0.25
MARGIN = 1.15
PME_ARGS = (16, 16, 16, 5, 0.6, 1389.35457)
PME_CUTOFF = 5.0


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def system():
    water = make_water_box(150, seed=0)
    n = len(water.positions)
    excl = np.full((n, 1), -1, np.int32)
    jp = j_init(jax.random.PRNGKey(0), JBasis.ani2x(),
                layer_dims=[(32, 24, 16)] * 7, num_models=2,
                self_energies=np.linspace(-40, -1, 7))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device='cpu')
    jani = JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN)
    jff = JANIWithPME.create(jani, JPME(*PME_ARGS, excl), PME_CUTOFF,
                             positions=water.positions, box=water.box)
    tani = ANIModel.from_atomic_numbers(
        water.atomic_numbers, ANIBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN)
    tff = ANIWithPME.create(tani, PME(*PME_ARGS, excl, device='cpu'),
                            PME_CUTOFF, positions=water.positions,
                            box=water.box)
    jcl = jani.create_cell_list(water.box, skin=SKIN)
    tcl = tani.create_cell_list(water.box, skin=SKIN)
    jpos, jq, jbox = (jnp.asarray(a) for a in (water.positions, water.charges,
                                                water.box))
    jsel = jax.jit(jff.select, static_argnums=(2,))(jpos, jbox, jcl)
    tpos, tq, tbox = (torch.tensor(a) for a in (water.positions,
                                                 water.charges, water.box))
    tsel = tff.select(tpos, tbox, tcl)
    return dict(water=water, jp=jp, tp=tp, jff=jff, tff=tff, jcl=jcl,
                tcl=tcl, jargs=(jpos, jq, jbox), targs=(tpos, tq, tbox),
                jsel=jsel, tsel=tsel)


def test_plan_equals_jax(system):
    plan = system['tff'].pme_window_plan
    assert plan == system['jff'].pme_window_plan
    assert plan[0] == (3, 3, 3)


def test_step_matches_jax(system):
    s = system
    jpos, jq, jbox = s['jargs']
    step = jax.jit(s['jff'].energy_and_forces_from_selection,
                   static_argnums=(4,))
    je, jf = step(s['jp'], jpos, jq, jbox, s['jcl'], s['jsel'])
    te, tf = s['tff'].energy_and_forces_from_selection(
        s['tp'], *s['targs'], s['tcl'], s['tsel'])
    je, jf = float(je), np.asarray(jf)
    assert tuple(tf.shape) == (s['tff'].ani.num_atoms, 3)
    np.testing.assert_allclose(float(te), je, rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=2e-4,
                               atol=2e-5 * np.abs(jf).max())
    # On the CPU every kernel already runs its plain version.
    pe, pf = plain_energy_and_forces(s['tff'], s['tp'], *s['targs'], s['tcl'],
                                     s['tsel'])
    assert float(pe) == float(te) and torch.equal(pf, tf)
    with torch.no_grad():
        e_sel = s['tff'].energy_from_selection(s['tp'], *s['targs'], s['tcl'],
                                               s['tsel'])
        e_one = s['tff'].energy(s['tp'], *s['targs'], s['tcl'])
    np.testing.assert_allclose(float(e_sel), float(te), rtol=1e-6)
    np.testing.assert_allclose(float(e_one), float(te), rtol=1e-6)


def test_overflow_counts_equal_jax(system):
    s = system
    jc = s['jff'].overflow_counts(*s['jargs'], s['jcl'], s['jsel'])
    tc = s['tff'].overflow_counts(*s['targs'], s['tcl'], s['tsel'])
    assert sorted(tc) == sorted(jc)
    assert {'pme_window_occupancy', 'pme_spread_chunk'} <= set(tc)
    for k in jc:
        got, want = tc[k].numpy(), np.asarray(jc[k])
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, k)
    s['tff'].check_overflow(*s['targs'], s['tcl'], s['tsel'])
    caps = s['tff'].capacities(s['tcl'])
    assert caps['pme_window_occupancy'] == s['tff'].pme_window_plan[1]
    over = dict(tc, pme_window_occupancy=torch.tensor(caps[
        'pme_window_occupancy'] + 1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match='pme_window_occupancy'):
        s['tff'].check_counts(over, s['tcl'])


def test_forces_match_finite_differences(system):
    """E(x - d F) - E(x + d F) = 2 d |F|^2 against the frozen selection."""
    s = system
    pos, q, box = s['targs']
    _, f = s['tff'].energy_and_forces_from_selection(s['tp'], pos, q, box,
                                                     s['tcl'], s['tsel'])
    norm = float(torch.linalg.norm(f))
    d = 1e-3 / norm

    def energy(p):
        with torch.no_grad():
            return float(s['tff'].energy_from_selection(s['tp'], p, q, box,
                                                        s['tcl'], s['tsel']))
    fd = (energy(pos - d * f) - energy(pos + d * f)) / 2e-3
    np.testing.assert_allclose(fd, norm, rtol=5e-3, atol=1e-4)


def test_without_window_plan_raises(system):
    s = system
    ff = ANIWithPME(ani=s['tff'].ani, pme=s['tff'].pme, pme_cutoff=5.0)
    with pytest.raises(NotImplementedError, match='A.6'):
        ff.energy_from_selection(s['tp'], *s['targs'], s['tcl'], s['tsel'])


def test_config5_builder_matches_jax_example(system):
    """``config5`` builds the settings of the JAX example's config 5
    (examples/run_configs.py): the window layout, the PME grid, parameters
    and bucketed window plan, the scaled charges and the masses; its PME
    energy (direct, reciprocal and self) equals JAX's on them."""
    s = system
    water = s['water']
    n = len(water.positions)
    c5 = config5(water, ANIBasis.ani2x(), device='cpu')
    ff = c5.model
    grid = max(16, int(2 ** np.ceil(np.log2(water.box[0][0]))))
    jani = JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, impl='window', skin=0.25)
    jff = JANIWithPME.create(
        jani, JPME(grid, grid, grid, 5, 0.6, 1389.35457,
                   np.full((n, 1), -1, np.int32)),
        5.0, positions=water.positions, box=water.box)
    cfg = ff.pme.config
    assert (cfg.grid_shape, cfg.order, cfg.alpha, cfg.coulomb) == (
        (grid,) * 3, 5, 0.6, 1389.35457)
    assert ff.pme_cutoff == 5.0
    assert ff.pme_window_plan == jff.pme_window_plan
    assert ff.ani.aev_impl == 'window' and ff.ani.nn_impl == 'fused'
    assert ff.ani.blocked_layout.cell_caps == jani.blocked_layout.cell_caps
    jq = jnp.asarray(water.charges) * 0.2
    np.testing.assert_array_equal(c5.charges.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        c5.masses.numpy(), np.where(water.atomic_numbers == 8, 16.0, 1.0))
    e = float(ff._pme_direct(c5.positions, c5.charges, c5.box)
              + ff._pme_reciprocal(c5.positions, c5.charges, c5.box))
    je = float(jff._pme_energy(jnp.asarray(water.positions), jq,
                               jnp.asarray(water.box), s['jcl']))
    np.testing.assert_allclose(e, je, rtol=1e-5)
