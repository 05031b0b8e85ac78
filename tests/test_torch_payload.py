"""The port's payload ANI-2x path (BASELINE config 3: ``CellList.build``
and ``neighbor_list_to_pairs``, ``compute_aev_from_payload``,
``max_angular_neighbors``, ``build_blocked_payload``, the chunked blocked
AEV, and the ``ANIModel`` payload entry points with sticky MD) against the
JAX package on the same numpy inputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.md import integrators as jmd
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.neighbors import blocked as jblocked
from nnpops_tpu.neighbors.cell_list import CellList as JCellList
from nnpops_tpu.neighbors.cell_list import \
    neighbor_list_to_pairs as j_list_to_pairs
from nnpops_tpu.ops import aev as jaev
from nnpops_tpu.ops.aev_blocked import compute_aev_blocked as j_aev_blocked
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.md import integrators as tmd
from nnpops_tpu_torch.models.ani import ANIModel, species_from_atomic_numbers
from nnpops_tpu_torch.neighbors import blocked as tblocked
from nnpops_tpu_torch.neighbors.cell_list import (CellList, NeighborList,
                                                  SlotSelection,
                                                  neighbor_list_to_pairs)
from nnpops_tpu_torch.ops import aev as taev
from nnpops_tpu_torch.ops.aev_blocked import compute_aev_blocked
from nnpops_tpu_torch.params import from_jax_params
from nnpops_tpu_torch.utils import make_triclinic_water_box, make_water_box

RC = 5.1


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several pytest workers on a few
    cores, where every small op's thread pool would contend with the
    others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def params():
    jp = j_init(jax.random.PRNGKey(0), JBasis.ani2x(),
                self_energies=np.linspace(-40, -1, 7))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device='cpu')


def boxes():
    rect = make_water_box(150, seed=0)
    tri = make_triclinic_water_box(300, seed=0)
    small = make_water_box(60, seed=5)      # under 3 cells: all pairs
    return {'rectangular': (rect.positions, rect.box),
            'triclinic': (tri.positions, tri.box),
            'dense': (small.positions, small.box)}


BOXES = boxes()


@pytest.mark.parametrize('capacity', [96, 40])
@pytest.mark.parametrize('name', sorted(BOXES))
def test_build_equals_jax(name, capacity):
    """Indices, ``max_neighbors`` and ``max_cell_occupancy`` equal JAX's,
    int32, also when the capacity truncates (40 < the true maximum)."""
    pos, box = BOXES[name]
    jcl = JCellList.create(box, RC, capacity=capacity)
    tcl = CellList.create(box, RC, capacity=capacity)
    assert tcl.use_cells == jcl.use_cells == (name != 'dense')
    want = jax.jit(jcl.build)(jnp.asarray(pos), jnp.asarray(box))
    got = tcl.build(torch.tensor(pos), torch.tensor(box))
    assert isinstance(got, NeighborList)
    assert got.indices.dtype == got.max_neighbors.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert int(got.max_neighbors) == int(want.max_neighbors)
    assert int(got.max_cell_occupancy) == int(want.max_cell_occupancy)
    assert bool(got.did_overflow(capacity, tcl.cell_capacity)) == (
        int(want.max_neighbors) > capacity)


def test_neighbor_list_to_pairs_matches_jax():
    pos, box = BOXES['triclinic']
    jcl = JCellList.create(box, RC, capacity=96)
    tcl = CellList.create(box, RC, capacity=96)
    want = jax.jit(lambda p, b: j_list_to_pairs(jcl.build(p, b), p, b))(
        jnp.asarray(pos), jnp.asarray(box))
    tpos = torch.tensor(pos, requires_grad=True)
    got = neighbor_list_to_pairs(tcl.build(tpos, torch.tensor(box)), tpos,
                                 torch.tensor(box))
    for field in ('atom1', 'atom2', 'mask', 'num_pairs'):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), field)
    np.testing.assert_allclose(got.deltas.detach().numpy(),
                               np.asarray(want.deltas), atol=1e-5)
    np.testing.assert_allclose(got.distances.detach().numpy(),
                               np.asarray(want.distances), rtol=1e-6,
                               atol=1e-6)
    torch.sum(got.distances).backward()
    assert torch.isfinite(tpos.grad).all()


@functools.lru_cache(maxsize=None)
def system(name):
    """The two systems of ``tests/test_fused_aev.py``: 4 cells an axis, and
    a small box on the all-pairs fallback."""
    water = (make_water_box(300, seed=2) if name == 'cells'
             else make_water_box(60, seed=5))
    sp = species_from_atomic_numbers(water.atomic_numbers)
    onehot = np.eye(7, dtype=np.float32)[sp]
    jcl = JCellList.create(water.box, RC, capacity=96)
    tcl = CellList.create(water.box, RC, capacity=96)
    assert tcl.use_cells == (name == 'cells')
    jp = jax.jit(lambda p: jcl.build_payload(p, jnp.asarray(water.box),
                                             jnp.asarray(onehot)))(
        jnp.asarray(water.positions))
    tp = tcl.build_payload(torch.tensor(water.positions),
                           torch.tensor(water.box), torch.tensor(onehot))
    return water, jcl, tcl, jp, tp


SYSTEMS = ('cells', 'dense')


def jax_payload_aev(jp, cap=32, **kw):
    radial, angular = jax.jit(lambda p: jaev.compute_aev_from_payload(
        p, JBasis.ani2x(), cap, **kw))(jp)
    return np.asarray(radial), np.asarray(angular)


@pytest.mark.parametrize('name', SYSTEMS)
def test_payload_aev_matches_jax(name):
    _, _, _, jp, tp = system(name)
    assert int(tp.max_neighbors) == int(jp.max_neighbors)
    radial, angular = taev.compute_aev_from_payload(tp, ANIBasis.ani2x(), 32)
    jr, ja = jax_payload_aev(jp)
    np.testing.assert_allclose(radial.numpy(), jr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(angular.numpy(), ja, rtol=1e-5, atol=1e-5)
    assert int(taev.max_angular_neighbors(tp, 3.5)) == int(
        jaev.max_angular_neighbors(jp, 3.5))


@pytest.mark.parametrize('name', SYSTEMS)
def test_chunked_equals_unchunked(name):
    tp = system(name)[4]
    basis = ANIBasis.ani2x()
    full = taev.compute_aev_from_payload(tp, basis, 32)
    chunked = taev.compute_aev_from_payload(tp, basis, 32, chunk_size=64)
    for a, b in zip(chunked, full):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_bf16_contraction_matches_jax():
    """``contraction_dtype=bf16`` against JAX's: the two round the same
    terms to bf16 and sum them in f32 in different orders, so a term one
    ulp apart before rounding can land one bf16 ulp apart (2^-8)."""
    _, _, _, jp, tp = system('cells')
    radial, angular = taev.compute_aev_from_payload(
        tp, ANIBasis.ani2x(), 32, contraction_dtype=torch.bfloat16)
    jr, ja = jax_payload_aev(jp, contraction_dtype=jnp.bfloat16)
    full = taev.compute_aev_from_payload(tp, ANIBasis.ani2x(), 32)
    for got, want, f32 in ((radial, jr, full.radial),
                           (angular, ja, full.angular)):
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 2 ** -8 * scale
        # and it is a bf16 result, not the f32 one
        assert not torch.equal(got, f32)


@pytest.mark.parametrize('impl', taev.ANGULAR_IMPLS)
def test_every_angular_impl_name_runs_the_one_formulation(impl):
    """The JAX package's four TPU layouts of the angular sum ('ordered3',
    'dense', 'pair', 'ordered2') are one formulation in the port: each name
    gives the default's result exactly, and JAX's layout of that name."""
    _, _, _, jp, tp = system('cells')
    basis = ANIBasis.ani2x()
    default = taev.compute_aev_from_payload(tp, basis, 32)
    got = taev.compute_aev_from_payload(tp, basis, 32, angular_impl=impl)
    assert torch.equal(got.angular, default.angular)
    _, ja = jax_payload_aev(jp, angular_impl=impl)
    np.testing.assert_allclose(got.angular.numpy(), ja, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='angular_impl'):
        taev.compute_aev_from_payload(tp, basis, 32, angular_impl='ordered')


def small_basis(cls):
    return cls.from_grids(
        num_species=3, Rcr=4.2, Rca=3.1, EtaR=[16.0],
        ShfR=[0.9, 1.7, 2.5, 3.3], EtaA=[8.0], Zeta=[32.0],
        ShfA=[0.9, 1.6, 2.3], ShfZ=[0.2, 1.2, 2.2])


def test_build_blocked_payload_and_chunked_blocked_aev_match_jax():
    """``build_blocked_payload`` (select + payload) and ``compute_aev_blocked``
    with ``chunk_size`` against JAX's, on ``tests/test_aev_blocked.py``'s
    random system."""
    rng = np.random.RandomState(3)
    pos = rng.rand(64, 3).astype(np.float32) * 11.0
    species = rng.randint(0, 3, 64).astype(np.int32)
    box = np.eye(3, dtype=np.float32) * 11.0
    jb, tb = small_basis(JBasis), small_basis(ANIBasis)
    jl = jblocked.plan_blocked_layout(pos, box, species, jb.radial_cutoff,
                                      jb.angular_cutoff, jb.num_species)
    tl = tblocked.plan_blocked_layout(pos, box, species, tb.radial_cutoff,
                                      tb.angular_cutoff, tb.num_species)
    assert (tl.rad_caps, tl.ang_caps) == (jl.rad_caps, jl.ang_caps)
    jcl = JCellList.create(box, jb.radial_cutoff, capacity=jl.rad_total)
    tcl = CellList.create(box, tb.radial_cutoff, capacity=tl.rad_total)
    jpay = jax.jit(lambda p, b: jblocked.build_blocked_payload(
        jcl, p, b, species, jl, jb.radial_cutoff, jb.angular_cutoff))(
            jnp.asarray(pos), jnp.asarray(box))
    tpay = tblocked.build_blocked_payload(
        tcl, torch.tensor(pos), torch.tensor(box), species, tl,
        tb.radial_cutoff, tb.angular_cutoff)
    for field in ('rad_mask', 'ang_mask', 'max_rad', 'max_ang',
                  'max_cell_occupancy'):
        np.testing.assert_array_equal(getattr(tpay, field).numpy(),
                                      np.asarray(getattr(jpay, field)), field)
    for field in ('rad_deltas', 'rad_r', 'ang_deltas', 'ang_r'):
        np.testing.assert_allclose(getattr(tpay, field).numpy(),
                                   np.asarray(getattr(jpay, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)
    want = jax.jit(lambda p: j_aev_blocked(p, jb, jl, chunk_size=16))(jpay)
    got = compute_aev_blocked(tpay, tb, tl, 16)
    full = compute_aev_blocked(tpay, tb, tl)
    for a, b, c in zip(got, want, full):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6,
                                   atol=1e-7)


def models(water, **kw):
    return (JModel.from_atomic_numbers(water.atomic_numbers, JBasis.ani2x(),
                                       **kw),
            ANIModel.from_atomic_numbers(water.atomic_numbers, ANIBasis.ani2x(),
                                         **kw))


def check(je, jf, te, tf, bf16=False):
    je, jf, te, tf = float(je), np.asarray(jf), float(te), tf.numpy()
    assert np.isfinite(tf).all()
    if bf16:
        np.testing.assert_allclose(te, je, rtol=1e-4)
        assert np.abs(tf - jf).max() <= 5e-3 * np.abs(jf).max()
    else:
        np.testing.assert_allclose(te, je, rtol=1e-6)
        np.testing.assert_allclose(tf, jf, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize('aev_bf16', [False, True])
@pytest.mark.parametrize('name', SYSTEMS)
def test_energy_and_forces_fused_matches_jax(params, name, aev_bf16):
    jp, tp = params
    water, jcl, tcl, _, _ = system(name)
    jm, tm = models(water, angular_capacity=32, aev_bf16=aev_bf16)
    assert tm.aev_impl == 'payload'
    jbox, tbox = jnp.asarray(water.box), torch.tensor(water.box)
    je, jf = jax.jit(lambda pr, p: jm.energy_and_forces_fused(
        pr, p, jbox, jcl))(jp, jnp.asarray(water.positions))
    te, tf = tm.energy_and_forces_fused(tp, torch.tensor(water.positions),
                                        tbox, tcl)
    check(je, jf, te, tf, aev_bf16)


SKIN = 0.5


def sticky(water, capacity=96):
    """Cell lists at the cutoff plus the skin (at least 3 cells an axis:
    ``select`` has no one-cell guard)."""
    jcl = JCellList.create(water.box, RC + SKIN, capacity=capacity)
    tcl = CellList.create(water.box, RC + SKIN, capacity=capacity)
    assert tcl.use_cells
    return jcl, tcl


def test_energy_and_forces_from_slot_selection_matches_jax(params):
    """One frozen SlotSelection, the positions nudged inside the skin."""
    jp, tp = params
    water = make_water_box(200, seed=0)
    jm, tm = models(water, angular_capacity=32, aev_chunk_size=128)
    jcl, tcl = sticky(water)
    jbox, tbox = jnp.asarray(water.box), torch.tensor(water.box)
    jsel = jm.select(jnp.asarray(water.positions), jbox, jcl)
    tsel = tm.select(torch.tensor(water.positions), tbox, tcl)
    assert isinstance(tsel, SlotSelection)
    pos = (water.positions + np.random.RandomState(2).uniform(
        -0.05, 0.05, water.positions.shape)).astype(np.float32)
    je, jf = jax.jit(jm.energy_and_forces_from_selection,
                     static_argnums=(3,))(jp, jnp.asarray(pos), jbox, jcl, jsel)
    te, tf = tm.energy_and_forces_from_selection(tp, torch.tensor(pos), tbox,
                                                 tcl, tsel)
    check(je, jf, te, tf)
    with torch.no_grad():
        e_only = tm.energy_from_selection(tp, torch.tensor(pos), tbox, tcl,
                                          tsel)
    np.testing.assert_allclose(float(e_only), float(te), rtol=1e-6)
    for jsel_or_none, sel in ((jsel, tsel), (None, None)):
        jc = jm.overflow_counts(jnp.asarray(pos), jbox, jcl, jsel_or_none)
        tc = tm.overflow_counts(torch.tensor(pos), tbox, tcl, sel)
        assert sorted(tc) == sorted(jc)
        for k in jc:
            assert tc[k].dtype == torch.int32
            assert int(tc[k]) == int(jc[k]), k
    tm.check_overflow(torch.tensor(pos), tbox, tcl, tsel)


def test_check_overflow_raises_on_small_capacities():
    water = make_water_box(150, seed=0)
    tpos, tbox = torch.tensor(water.positions), torch.tensor(water.box)
    tcl = CellList.create(water.box, RC, capacity=96)
    _, tm = models(water, angular_capacity=8)
    with pytest.raises(RuntimeError, match='max_angular'):
        tm.check_overflow(tpos, tbox, tcl)
    _, tm = models(water, angular_capacity=32)
    tm.check_overflow(tpos, tbox, tcl)
    small = CellList.create(water.box, RC, capacity=40)
    with pytest.raises(RuntimeError, match='max_neighbors'):
        tm.check_overflow(tpos, tbox, small)


def test_run_md_sticky_velocity_verlet_matches_jax(params):
    """Two refresh blocks of four velocity-Verlet steps on the payload path,
    with the angular neighbor count as the extra overflow count."""
    jp, tp = params
    water = make_water_box(200, seed=6)
    jm, tm = models(water, angular_capacity=32)
    jcl, tcl = sticky(water)
    jbox, tbox = jnp.asarray(water.box), torch.tensor(water.box)
    masses = np.where(water.atomic_numbers == 8, 16.0, 1.0).astype(np.float32)
    vel = (np.random.RandomState(3).randn(*water.positions.shape)
           * np.sqrt(0.596 / masses)[:, None]).astype(np.float32)
    dt, ra = 5e-4, JBasis.ani2x().angular_cutoff

    def j_force(sel, p):
        return jm.energy_and_forces_from_selection(jp, p, jbox, jcl, sel)

    def j_run(state):
        return jmd.run_md_sticky(
            lambda p: jm.select(p, jbox, jcl), j_force,
            lambda ff: jmd.velocity_verlet(ff, jnp.asarray(masses), dt),
            state, 8, 4,
            lambda sel, p: jaev.max_angular_neighbors(
                jcl.payload_from_selection(p, jbox, sel), ra))

    jpos = jnp.asarray(water.positions)
    je0, jf0 = j_force(jm.select(jpos, jbox, jcl), jpos)
    jfinal, jenergies, jstats = jax.jit(j_run)(jmd.MDState(
        jpos, jnp.asarray(vel), jf0, je0, jax.random.PRNGKey(0),
        jnp.zeros((), jnp.int32)))

    def t_force(sel, p):
        return tm.energy_and_forces_from_selection(tp, p, tbox, tcl, sel)

    tpos = torch.tensor(water.positions)
    te0, tf0 = t_force(tm.select(tpos, tbox, tcl), tpos)
    tfinal, tenergies, tstats = tmd.run_md_sticky(
        lambda p: tm.select(p, tbox, tcl), t_force,
        lambda ff: tmd.velocity_verlet(ff, torch.tensor(masses), dt),
        tmd.MDState(tpos, torch.tensor(vel), tf0, te0, torch.Generator(),
                    torch.zeros((), dtype=torch.int32)), 8, 4,
        lambda sel, p: taev.max_angular_neighbors(
            tcl.payload_from_selection(p, tbox, sel), ra))
    np.testing.assert_allclose(tenergies.numpy(), np.asarray(jenergies),
                               rtol=1e-6)
    np.testing.assert_allclose(tfinal.positions.numpy(),
                               np.asarray(jfinal.positions), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tfinal.velocities.numpy(),
                               np.asarray(jfinal.velocities), rtol=1e-3,
                               atol=1e-4)
    for k in ('max_neighbors', 'max_cell_occupancy', 'max_extra'):
        assert int(getattr(tstats, k)) == int(getattr(jstats, k)), k
    tstats.check(tcl.capacity, tcl.cell_capacity, 32)
