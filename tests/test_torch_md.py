"""The port's MD integrators and checkpointing (``nnpops_tpu_torch.md``):
the LJ toy of the JAX suite stepped by both packages from the same numpy
state (velocity Verlet, and Langevin at kT = 0 where the noise term is
multiplied by zero), the thermostat, record shapes, bit-exact resume, and
Verlet-skin stepping of the ANI + PME model against a per-step rebuild."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.md import integrators as jmd
from nnpops_tpu_torch.md import (MDState, initialize, kinetic_energy,
                                 langevin_baoab, load_checkpoint, run_md,
                                 run_md_sticky, run_md_sticky_counts,
                                 save_checkpoint, velocity_verlet)

N = 16
KT = 0.5


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lj_energy(positions, xp):
    """The JAX suite's soft Lennard-Jones toy, for jnp or torch."""
    delta = positions[None] - positions[:, None]
    eye = xp.eye(N, dtype=positions.dtype)
    d2 = (delta * delta).sum(-1) + eye
    inv6 = 1.0 / (d2 ** 3)
    return xp.triu(inv6 * inv6 - inv6, 1).sum()


def t_force(p):
    with torch.enable_grad():
        x = p.detach().requires_grad_(True)
        e = lj_energy(x, torch)
        (g,) = torch.autograd.grad(e, x)
    return e.detach(), -g


def j_force(p):
    e, g = jax.value_and_grad(lambda x: lj_energy(x, jnp))(p)
    return e, -g


@pytest.fixture(scope='module')
def start():
    """Positions on a loose grid, velocities, and the masses, in numpy."""
    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*[np.arange(4)] * 2, [0], indexing='ij'),
                    axis=-1).reshape(-1, 3)[:N] * 1.5
    pos = (grid + 0.05 * rng.randn(N, 3)).astype(np.float32)
    vel = (np.sqrt(KT / 2.0) * rng.randn(N, 3)).astype(np.float32)
    return pos, vel, np.full(N, 2.0, np.float32)


def states(start, seed=0):
    pos, vel, _ = start
    e, f = t_force(torch.tensor(pos))
    ts = MDState(torch.tensor(pos), torch.tensor(vel), f, e,
                 torch.Generator().manual_seed(seed),
                 torch.zeros((), dtype=torch.int32))
    je, jf = j_force(jnp.asarray(pos))
    js = jmd.MDState(jnp.asarray(pos), jnp.asarray(vel), jf, je,
                     jax.random.PRNGKey(seed), jnp.zeros((), jnp.int32))
    return ts, js


@pytest.mark.parametrize('integrator', ['verlet', 'langevin-kT0'])
def test_trajectory_matches_jax(start, integrator):
    masses = start[2]
    ts, js = states(start)
    if integrator == 'verlet':
        t_step = velocity_verlet(t_force, torch.tensor(masses), 0.002)
        j_step = jmd.velocity_verlet(j_force, jnp.asarray(masses), 0.002)
    else:
        t_step = langevin_baoab(t_force, torch.tensor(masses), 0.002, 5.0, 0.0)
        j_step = jmd.langevin_baoab(j_force, jnp.asarray(masses), 0.002, 5.0,
                                    0.0)
    t_final, t_e = run_md(t_step, ts, 100, record_every=10)
    j_final, j_e = jax.jit(lambda s: jmd.run_md(j_step, s, 100,
                                                record_every=10))(js)
    assert int(t_final.step) == int(j_final.step) == 100
    np.testing.assert_allclose(t_e.numpy(), np.asarray(j_e), rtol=1e-4,
                               atol=1e-5)
    for name in ('positions', 'velocities', 'forces'):
        got = getattr(t_final, name).numpy()
        want = np.asarray(getattr(j_final, name))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_nve_energy_conservation(start):
    masses = torch.tensor(start[2])
    state = initialize(t_force, torch.tensor(start[0]), masses, KT,
                       torch.Generator().manual_seed(0))
    e0 = float(state.energy + kinetic_energy(state, masses))
    final, _ = run_md(velocity_verlet(t_force, masses, 0.002), state, 500,
                      record_every=500)
    e1 = float(final.energy + kinetic_energy(final, masses))
    assert abs(e1 - e0) < 5e-3 * max(1.0, abs(e0))


def test_langevin_thermalizes(start):
    """BAOAB drives the kinetic energy toward (3/2) N kT."""
    masses = torch.tensor(start[2])
    state = initialize(t_force, torch.tensor(start[0]), masses, KT,
                       torch.Generator().manual_seed(1))
    final, energies = run_md(langevin_baoab(t_force, masses, 0.005, 5.0, KT),
                             state, 2000, record_every=100)
    ke = float(kinetic_energy(final, masses))
    target = 1.5 * N * KT
    assert 0.4 * target < ke < 2.0 * target
    assert torch.isfinite(energies).all() and int(final.step) == 2000


def test_run_md_records(start):
    masses = torch.tensor(start[2])
    state = initialize(t_force, torch.tensor(start[0]), masses, KT,
                       torch.Generator().manual_seed(2))
    step = langevin_baoab(t_force, masses, 0.002, 1.0, KT)
    s1, e1 = run_md(step, state, 50, record_every=10)
    s2, e2 = run_md(step, s1, 50, record_every=10)
    assert tuple(e1.shape) == tuple(e2.shape) == (5,)
    assert int(s2.step) == 100 and e1.dtype == state.energy.dtype
    np.testing.assert_allclose(float(e2[-1]), float(s2.energy))


def test_checkpoint_resume_exact(tmp_path, start):
    """Save at step k, resume, and get bit-identical Langevin
    trajectories: the generator's state is in the checkpoint."""
    masses = torch.tensor(start[2])
    step = langevin_baoab(t_force, masses, 0.002, 1.0, KT)
    state = initialize(t_force, torch.tensor(start[0]), masses, KT,
                       torch.Generator().manual_seed(3))
    mid, _ = run_md(step, state, 100)
    path = str(tmp_path / 'state.npz')
    save_checkpoint(path, mid)
    restored = load_checkpoint(path, mid)
    assert restored.generator is not mid.generator
    final_a, _ = run_md(step, mid, 100)
    final_b, _ = run_md(step, restored, 100)
    for name in ('positions', 'velocities', 'forces', 'energy', 'step'):
        assert torch.equal(getattr(final_a, name), getattr(final_b, name)), name
    assert not (tmp_path / 'state.npz.tmp').exists()


def test_checkpoint_shape_mismatch_raises(tmp_path, start):
    masses = torch.tensor(start[2])
    state = initialize(t_force, torch.tensor(start[0]), masses, KT,
                       torch.Generator().manual_seed(0))
    path = str(tmp_path / 'state.npz')
    save_checkpoint(path, state)
    with pytest.raises(ValueError, match='shape mismatch'):
        load_checkpoint(path, state._replace(positions=torch.zeros(N + 1, 3)))
    with pytest.raises(ValueError, match='leaves'):
        load_checkpoint(path, (state, state))


class _Sel:
    """A stand-in selection with the two counts run_md_sticky tracks."""

    def __init__(self, pos):
        d = torch.cdist(pos, pos)
        self.max_neighbors = torch.max(torch.sum(d < 2.0, 1) - 1).int()
        self.max_cell_occupancy = torch.tensor(N, dtype=torch.int32)


def test_run_md_sticky_overflow_stats(start):
    masses = torch.tensor(start[2])
    state = initialize(t_force, torch.tensor(start[0]), masses, KT,
                       torch.Generator().manual_seed(4))
    final, energies, stats = run_md_sticky(
        _Sel, lambda sel, p: t_force(p),
        lambda ff: velocity_verlet(ff, masses, 0.002), state, 12, 4,
        overflow_fn=lambda sel, p: sel.max_neighbors + 1)
    assert tuple(energies.shape) == (3,) and int(final.step) == 12
    assert int(stats.max_extra) == int(stats.max_neighbors) + 1
    stats.check(capacity=N, cell_capacity=N)
    with pytest.raises(RuntimeError, match='max_neighbors'):
        stats.check(capacity=0, cell_capacity=N)


def test_sticky_counts_combined_matches_rebuild():
    """Verlet-skin stepping of the ANI + PME model (2 blocks x 2 steps)
    matches refreshing the selection every step, and the stats keys are
    JAX's ``ANIWithPME.overflow_counts`` keys."""
    from nnpops_tpu.config import ANIBasis as JBasis
    from nnpops_tpu.models.ani import ANIModel as JModel
    from nnpops_tpu.models.combined import ANIWithPME as JANIWithPME
    from nnpops_tpu.ops.pme import PME as JPME
    from nnpops_tpu_torch.config import ANIBasis
    from nnpops_tpu_torch.models.ani import ANIModel, init_ani_params
    from nnpops_tpu_torch.models.combined import ANIWithPME
    from nnpops_tpu_torch.ops.pme import PME
    from nnpops_tpu_torch.utils import make_water_box

    water = make_water_box(150, seed=0)
    n = len(water.positions)
    excl = np.full((n, 1), -1, np.int32)
    pme_args = (16, 16, 16, 5, 0.6, 1389.35457)
    ani = ANIModel.from_atomic_numbers(
        water.atomic_numbers, ANIBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, impl='window', skin=0.25)
    ff = ANIWithPME.create(ani, PME(*pme_args, excl, device='cpu'), 5.0,
                           positions=water.positions, box=water.box)
    params = init_ani_params(torch.Generator().manual_seed(0), ani.basis,
                             layer_dims=[(32, 24, 16)] * 7, num_models=2,
                             self_energies=np.linspace(-40, -1, 7),
                             device='cpu')
    cells = ani.create_cell_list(water.box, skin=0.25)
    box = torch.tensor(water.box)
    charges = torch.tensor(water.charges) * 0.2
    masses = torch.where(torch.tensor(water.atomic_numbers) == 8, 16.0, 1.0)

    def select_fn(p):
        return ff.select(p, box, cells)

    def force_fn_of_sel(sel, p):
        return ff.energy_and_forces_from_selection(params, p, charges, box,
                                                   cells, sel)

    def counts_fn(sel, p):
        return ff.overflow_counts(p, charges, box, cells, sel)

    def run(refresh):
        state = initialize(lambda p: force_fn_of_sel(select_fn(p), p),
                           torch.tensor(water.positions), masses, 0.596,
                           torch.Generator().manual_seed(1))
        return run_md_sticky_counts(
            select_fn, force_fn_of_sel,
            lambda f: langevin_baoab(f, masses, 2e-4, 5.0, 0.596), state, 4,
            refresh, counts_fn)

    final_a, e_a, stats_a = run(1)
    final_b, e_b, stats_b = run(2)
    assert tuple(e_a.shape) == (4,) and tuple(e_b.shape) == (2,)
    np.testing.assert_allclose(final_b.positions.numpy(),
                               final_a.positions.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(final_b.energy), float(final_a.energy),
                               rtol=1e-5)
    ff.check_counts(stats_b, cells)

    jani = JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, impl='window', skin=0.25)
    jff = JANIWithPME.create(jani, JPME(*pme_args, excl), 5.0,
                             positions=water.positions, box=water.box)
    jcl = jani.create_cell_list(water.box, skin=0.25)
    jpos, jbox = jnp.asarray(water.positions), jnp.asarray(water.box)
    jsel = jax.jit(jff.select, static_argnums=(2,))(jpos, jbox, jcl)
    jkeys = jff.overflow_counts(jpos, jnp.asarray(water.charges), jbox, jcl,
                                jsel).keys()
    assert sorted(stats_b) == sorted(jkeys)
    for k, v in stats_b.items():
        assert torch.equal(v, torch.maximum(v, stats_a[k])), k
