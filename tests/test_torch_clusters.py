"""The cluster-pair radial path (``window_radial='cluster'``:
``neighbors.clusters`` and ``ops.cuda_cluster``) against the JAX package's:

* the kernel's plain version against ``make_cluster_radial_kernel``
  (interpret mode) on synthetic lane planes (``lane_caps=(2, 2)``, padding
  rows and lanes, the self pairs at zero distance): the output and the VJP
  at f32 noise (rtol 1e-5, atol 1e-6 of the output's scale; gradients rtol
  1e-4, atol 1e-5 of their scale);
* ``plan_clusters`` field by field and ``select_clusters``' integer fields
  and four overflow counts exactly, at 1,000 molecules (the smallest water
  box the planner accepts); the image shifts and wraps to 1e-5 A;
* the planner refusing water(150) and a strongly triclinic box, the
  compressed-box overflow contract, keep-'window' in ``with_blocked_layout``
  where the planner refuses;
* the port's cluster step against its window step at 1,000 molecules, at
  the JAX suite's gate for that comparison (``test_cluster_aev.py:42-50``:
  energy rtol 1e-5, forces rtol 2e-4 and atol 2e-5 max|F|).

The JAX cluster step itself (interpret mode at 1,000 molecules) is in the
slow lane, as the JAX package's own cluster tests are."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.neighbors.clusters import plan_clusters as j_plan_clusters
from nnpops_tpu.neighbors.clusters import \
    select_clusters as j_select_clusters
from nnpops_tpu.ops.pallas_cluster import make_cluster_radial_kernel
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.models.ani import ANIModel
from nnpops_tpu_torch.neighbors.clusters import plan_clusters, select_clusters
from nnpops_tpu_torch.ops.cuda_cluster import (cluster_radial,
                                               cluster_radial_plain)
from nnpops_tpu_torch.ops.cuda_window import FAR
from nnpops_tpu_torch.params import from_jax_params
from nnpops_tpu_torch.utils import make_triclinic_water_box, make_water_box

SKIN = 0.25
MARGIN = 1.15
MOLECULES = 1000


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_planes(self_block, seed=0, ncl=8, cl=8, lane_caps=(2, 2)):
    """Lane planes ``[ncl, lanes]`` and centers ``[ncl, cl, 3]`` in a 7 A
    box: each i-cluster sits at the first j-cluster of block
    ``self_block`` (its own atoms, so its self pairs are at distance 0);
    two clusters are part padding (FAR rows and lanes), and a few other
    lanes are FAR."""
    rng = np.random.RandomState(seed)
    lanes = sum(lane_caps) * cl
    centers = rng.uniform(0.0, 7.0, (ncl, cl, 3)).astype(np.float32)
    centers[2, 5:] = FAR
    centers[5, 1:] = FAR
    planes = rng.uniform(0.0, 7.0, (ncl, lanes, 3)).astype(np.float32)
    planes[rng.rand(ncl, lanes) < 0.1] = FAR
    off = sum(lane_caps[:self_block]) * cl
    planes[:, off:off + cl] = centers
    return [np.ascontiguousarray(planes[..., k]) for k in range(3)], centers


@pytest.mark.parametrize('self_block', [0, 1])
def test_cluster_kernel_plain_matches_jax(self_block):
    basis = ANIBasis.ani2x()
    (jx, jy, jz), centers = synthetic_planes(self_block)
    real = centers[:, :, 0] < 0.5 * FAR
    rng = np.random.RandomState(1)
    g = (rng.randn(*centers.shape[:2], 2 * basis.num_radial)
         * real[..., None]).astype(np.float32)
    args = (basis.radial_cutoff, basis.radial_eta, basis.radial_rs, 8,
            (2, 2), self_block, basis.torchani)
    j_fn = make_cluster_radial_kernel(*args, interpret=True)
    j_out, j_vjp = jax.vjp(j_fn, *(jnp.asarray(a)
                                   for a in (jx, jy, jz, centers)))
    j_grads = j_vjp(jnp.asarray(g))
    t_in = [torch.tensor(a).requires_grad_(True)
            for a in (jx, jy, jz, centers)]
    t_out = cluster_radial_plain(*t_in, *args)
    t_grads = torch.autograd.grad(t_out, t_in, torch.tensor(g))
    t_out, j_out = t_out.detach().numpy(), np.asarray(j_out)
    assert t_out.shape == j_out.shape == (8, 8, 2 * basis.num_radial)
    # Padding rows are 0 in the port (see ops.cuda_cluster); nothing reads
    # them.
    assert not t_out[~real].any()
    assert np.abs(j_out[real]).max() > 0
    np.testing.assert_allclose(t_out[real], j_out[real], rtol=1e-5,
                               atol=1e-6 * np.abs(j_out[real]).max())
    for name, tg, jg in zip(('djx', 'djy', 'djz', 'dcenters'), t_grads,
                            j_grads):
        tg, jg = tg.numpy(), np.asarray(jg)
        assert np.isfinite(tg).all() and np.abs(jg).max() > 0, name
        np.testing.assert_allclose(tg, jg, rtol=1e-4,
                                   atol=1e-5 * np.abs(jg).max(), err_msg=name)


def test_cluster_cpu_dispatch_is_plain():
    basis = ANIBasis.ani2x()
    (jx, jy, jz), centers = synthetic_planes(1)
    ins = [torch.tensor(a) for a in (jx, jy, jz, centers)]
    args = (basis.radial_cutoff, basis.radial_eta, basis.radial_rs, 8,
            (2, 2), 1, basis.torchani)
    assert torch.equal(cluster_radial(*ins, *args),
                       cluster_radial_plain(*ins, *args))


@pytest.fixture(scope='module')
def system():
    water = make_water_box(MOLECULES, seed=0)
    base = ANIModel.from_atomic_numbers(water.atomic_numbers, ANIBasis.ani2x())
    window = base.with_blocked_layout(water.positions, water.box,
                                      margin=MARGIN, impl='window', skin=SKIN)
    cluster = base.with_blocked_layout(water.positions, water.box,
                                       margin=MARGIN, impl='window', skin=SKIN,
                                       radial_impl='cluster')
    assert cluster.window_radial == 'cluster'
    assert cluster.blocked_layout.cluster_plan is not None
    cl = window.create_cell_list(water.box, skin=SKIN)
    pos, box = torch.tensor(water.positions), torch.tensor(water.box)
    return water, window, cluster, cl, pos, box


def test_plan_matches_jax(system):
    water, _, cluster, _, _, _ = system
    basis = cluster.basis
    want = j_plan_clusters(water.positions, water.box, cluster.species_array,
                           basis.radial_cutoff, skin=SKIN, margin=MARGIN)
    got = cluster.blocked_layout.cluster_plan
    assert want is not None
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ('gid_base', 'ncl_total', 'slot_base', 'n_slots', 'ktot',
                 'n_entries'):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_selection_matches_jax(system):
    water, _, cluster, _, pos, box = system
    basis = cluster.basis
    plan = cluster.blocked_layout.cluster_plan
    jplan = j_plan_clusters(water.positions, water.box, cluster.species_array,
                            basis.radial_cutoff, skin=SKIN, margin=MARGIN)
    species = cluster.species_array
    js = jax.jit(lambda p, b: j_select_clusters(
        p, b, species, jplan, basis.radial_cutoff, skin=SKIN))(
            jnp.asarray(water.positions), jnp.asarray(water.box))
    ts = select_clusters(pos, box, species, plan, basis.radial_cutoff,
                         skin=SKIN)
    for f in ('slot_of_atom', 'max_jcount', 'max_cand', 'max_mir',
              'geom_violation'):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    assert len(ts.jlists) == len(js.jlists) == 2
    for i in range(2):
        for f in ('jlists', 'jmasks'):
            np.testing.assert_array_equal(getattr(ts, f)[i].numpy(),
                                          np.asarray(getattr(js, f)[i]), f)
        np.testing.assert_allclose(ts.shifts[i].numpy(),
                                   np.asarray(js.shifts[i]), atol=1e-5)
    np.testing.assert_allclose(ts.wrap_shift.numpy(),
                               np.asarray(js.wrap_shift), atol=1e-5)
    assert not bool(ts.did_overflow(plan))
    assert not bool(js.did_overflow(jplan))


def test_cluster_overflow_contract(system):
    """Compressing the system past the planned capacities is reported."""
    _, _, cluster, cl, pos, box = system
    plan = cluster.blocked_layout.cluster_plan
    sel = select_clusters(pos * 0.5, box, cluster.species_array, plan,
                          cluster.basis.radial_cutoff)
    assert bool(sel.did_overflow(plan))
    counts = cluster.overflow_counts(pos, box, cl)
    assert {'cluster_jcount', 'cluster_cand', 'cluster_mirror',
            'cluster_geom'} <= set(counts)
    cluster.check_overflow(pos, box, cl)
    small = dataclasses.replace(cluster, blocked_layout=dataclasses.replace(
        cluster.blocked_layout, cluster_plan=dataclasses.replace(
            plan, kmir=int(counts['cluster_mirror']) - 1)))
    with pytest.raises(RuntimeError, match='cluster_mirror'):
        small.check_overflow(pos, box, cl)


def test_plan_refuses_small_and_triclinic_boxes():
    water = make_water_box(150, seed=0)
    species = [0 if z == 8 else 1 for z in water.atomic_numbers]
    assert plan_clusters(water.positions, water.box, species, 5.1) is None
    assert j_plan_clusters(water.positions, water.box, species, 5.1) is None
    box = np.asarray(water.box, np.float64)
    box[1, 0] = 0.4 * box[0, 0]                    # strongly triclinic
    assert plan_clusters(water.positions, box, species, 5.1) is None
    tri = make_triclinic_water_box(300, seed=0)
    assert plan_clusters(tri.positions, tri.box,
                         [0 if z == 8 else 1 for z in tri.atomic_numbers],
                         5.1) is None


@pytest.mark.parametrize('impl', ['window', 'pallas'])
def test_radial_impl_follows_jax(impl):
    """Where the planner refuses the box, 'cluster' keeps 'window' (a
    planning decision of the reference); with impl='pallas' the radial
    switch is ignored. Both as in the JAX package."""
    water = make_water_box(150, seed=0)
    kw = dict(margin=MARGIN, impl=impl, skin=SKIN, radial_impl='cluster')
    got = ANIModel.from_atomic_numbers(
        water.atomic_numbers, ANIBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, **kw)
    want = JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, **kw)
    assert got.aev_impl == want.aev_impl == impl
    assert got.window_radial == want.window_radial == 'window'
    assert got.blocked_layout.cluster_plan is None
    assert want.blocked_layout.cluster_plan is None


@pytest.fixture(scope='module')
def params():
    jp = j_init(jax.random.PRNGKey(0), JBasis.ani2x(),
                layer_dims=[(32, 24, 16)] * 7, num_models=2)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device='cpu')


def test_cluster_step_matches_window_step(system, params):
    _, window, cluster, cl, pos, box = system
    tp = params[1]
    sel = cluster.select(pos, box, cl)
    assert sel.clusters is not None
    assert tuple(sel.shift_planes.shape) == (1, 1, 1)
    cluster.check_overflow(pos, box, cl, sel)
    e2, f2 = cluster.energy_and_forces_from_selection(tp, pos, box, cl, sel)
    e1, f1 = window.energy_and_forces_from_selection(
        tp, pos, box, cl, window.select(pos, box, cl))
    np.testing.assert_allclose(float(e2), float(e1), rtol=1e-5)
    np.testing.assert_allclose(f2.numpy(), f1.numpy(), rtol=2e-4,
                               atol=2e-5 * float(f1.abs().max()))


def test_cluster_needs_a_cluster_selection(system, params):
    _, window, cluster, cl, pos, box = system
    sel = window.select(pos, box, cl)
    with pytest.raises(ValueError, match='cluster_plan'):
        cluster.energy_and_forces_from_selection(params[1], pos, box, cl, sel)


@pytest.mark.slow          # interpret-mode cluster step at 1,000 molecules;
def test_cluster_step_matches_jax(system, params):  # quick lane: the kernel,
    """The JAX cluster step (its Pallas kernels in interpret mode) against
    the port's, selection and overflow counts included (the quick lane
    holds the kernel, the plan and the selection to JAX, and the step to
    the port's window step)."""
    water, _, cluster, cl, pos, box = system
    jp, tp = params
    jm = JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN, radial_impl='cluster')
    jcl = jm.create_cell_list(water.box, skin=SKIN)
    jpos, jbox = jnp.asarray(water.positions), jnp.asarray(water.box)
    jsel = jax.jit(jm.select, static_argnums=(2,))(jpos, jbox, jcl)
    je, jf = jax.jit(jm.energy_and_forces_from_selection,
                     static_argnums=(3,))(jp, jpos, jbox, jcl, jsel)
    sel = cluster.select(pos, box, cl)
    jc = jm.overflow_counts(jpos, jbox, jcl, jsel)
    tc = cluster.overflow_counts(pos, box, cl, sel)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), k)
    te, tf = cluster.energy_and_forces_from_selection(tp, pos, box, cl, sel)
    jf = np.asarray(jf)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=2e-4,
                               atol=2e-5 * np.abs(jf).max())
