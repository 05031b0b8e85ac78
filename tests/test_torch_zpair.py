"""The z-pair radial path (``window_radial='pair'``, ``ops.cuda_zpair``)
against the JAX package's on water(150) (a 3x3x3 radial grid):

* the kernel's plain version against ``_make_pair_kernels`` (interpret
  mode) on the real z-triples: both outputs and the VJP, with cotangents
  that are 0 on empty slots;
* ``pair_radial_aev`` (z-triples, shifts, kernel, fold) against the JAX
  function: the radial AEV and its gradient in the slots and the box;
* the pair force step against the JAX pair step, and against the port's
  own window step;
* the kernel's run table against ``PairGeometry``, and the occupied lanes
  leading every run on the selection.

Tolerances: the kernel against JAX at f32 noise (rtol 1e-5, atol 1e-6 of
the output's scale; gradients rtol 1e-4, atol 1e-5 of their scale, the
window radial test's gates); the pair step against the JAX pair step at
the window slice's gates (energy rtol 1e-5, forces rtol 2e-4 and atol
2e-5 max|F|); the pair step against the window step at the JAX suite's
own gate for that comparison (``test_window_aev.py``: energy rtol 1e-6,
forces rtol 1e-4 and atol 2e-6 max|F|)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.ops.pallas_zpair import _make_pair_kernels
from nnpops_tpu.ops.pallas_zpair import pair_radial_aev as j_pair_radial_aev
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.models.ani import ANIModel
from nnpops_tpu_torch.neighbors.window import _radial_slots
from nnpops_tpu_torch.ops.cuda_window import EMPTY_ROW
from nnpops_tpu_torch.ops.cuda_zpair import (PairGeometry, _column_cells,
                                             pair_inputs, pair_radial,
                                             pair_radial_aev,
                                             pair_radial_plain, pair_runs)
from nnpops_tpu_torch.params import from_jax_params
from nnpops_tpu_torch.utils import make_water_box

SKIN = 0.25
MARGIN = 1.15


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
    jp = j_init(jax.random.PRNGKey(0), JBasis.ani2x(),
                layer_dims=[(32, 24, 16)] * 7, num_models=2)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device='cpu')
    window = ANIModel.from_atomic_numbers(
        water.atomic_numbers, ANIBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN)
    pair = dataclasses.replace(window, window_radial='pair')
    cl = window.create_cell_list(water.box, skin=SKIN)
    pos, box = torch.tensor(water.positions), torch.tensor(water.box)
    return water, jp, tp, window, pair, cl, pos, box


@pytest.fixture(scope='module')
def slots(system):
    """The radial grid's slot positions ``[cc, 3]`` of the pair selection,
    as ``window_features`` builds them, with the grid and cell caps."""
    _, _, _, _, pair, cl, pos, box = system
    sel = pair.select(pos, box, cl)
    grid = tuple(int(x) for x in cl.ncells)
    assert grid == (3, 3, 3)
    return _radial_slots(pos, sel), grid, tuple(pair.blocked_layout.cell_caps)


def basis_args(basis):
    return (basis.radial_cutoff, basis.radial_eta, basis.radial_rs)


def test_pair_kernel_plain_matches_jax(system, slots):
    basis = system[3].basis
    s, grid, caps = slots
    box = system[7]
    ctr, z3, shift = (t.numpy() for t in pair_inputs(s, box, grid, caps))
    real_row = ctr[:, :, 0] < EMPTY_ROW
    # A neighbour-side lane is real when the column's z-triple lane is.
    cols = _column_cells(grid)[1:]                          # [4, ncells]
    real_lane = (z3[cols][:, :, 0, :] < EMPTY_ROW).transpose(1, 0, 2)
    assert real_row.any() and (~real_row).any() and (~real_lane).any()
    rng = np.random.RandomState(0)
    ga = rng.randn(*ctr.shape[:2], 2 * basis.num_radial).astype(np.float32)
    ga *= real_row[..., None]
    gb = rng.randn(len(ctr), 4, 2 * basis.num_radial,
                   z3.shape[2]).astype(np.float32)
    gb *= real_lane[:, :, None, :]

    j_fn = _make_pair_kernels(grid, caps, basis.radial_cutoff,
                              tuple(basis.radial_eta), tuple(basis.radial_rs),
                              0.25 if basis.torchani else 1.0, True)
    (ja, jb), j_vjp = jax.vjp(j_fn, jnp.asarray(ctr), jnp.asarray(z3),
                              jnp.asarray(shift))
    j_grads = j_vjp((jnp.asarray(ga), jnp.asarray(gb)))
    t_in = [torch.tensor(a).requires_grad_(True) for a in (ctr, z3, shift)]
    ta, tb = pair_radial_plain(*t_in, *basis_args(basis), grid, caps,
                               basis.torchani)
    t_grads = torch.autograd.grad((ta, tb), t_in,
                                  (torch.tensor(ga), torch.tensor(gb)))
    ta, tb, ja, jb = ta.detach().numpy(), tb.detach().numpy(), np.asarray(ja), \
        np.asarray(jb)
    assert ta.shape == ja.shape and tb.shape == jb.shape
    # Empty slots' rows are 0 in the port (see ops.cuda_zpair); the Pallas
    # kernel pairs them with empty lanes. Nothing reads them.
    assert not ta[~real_row].any()
    np.testing.assert_allclose(ta[real_row], ja[real_row], rtol=1e-5,
                               atol=1e-6 * np.abs(ja).max())
    mb = np.broadcast_to(real_lane[:, :, None, :], jb.shape)
    np.testing.assert_allclose(tb[mb], jb[mb], rtol=1e-5,
                               atol=1e-6 * np.abs(jb[mb]).max())
    for name, tg, jg in zip(('dctr', 'dz3', 'dshift'), t_grads, j_grads):
        tg, jg = tg.numpy(), np.asarray(jg)
        assert np.isfinite(tg).all() and np.abs(jg).max() > 0, name
        np.testing.assert_allclose(tg, jg, rtol=1e-4,
                                   atol=1e-5 * np.abs(jg).max(), err_msg=name)


def test_pair_radial_aev_matches_jax(system, slots):
    """The whole pair radial (z-triples, shifts, kernel, fold) and its
    gradients in the slot positions and the box, on the real slots."""
    basis = system[3].basis
    s, grid, caps = slots
    s = s.detach().numpy()
    box = system[7].numpy()
    real = s[:, 0] < EMPTY_ROW
    args = (grid, caps, *basis_args(basis), basis.torchani)

    def j_loss(sl, bx):
        out = j_pair_radial_aev(sl, bx, *args, interpret=True)
        return jnp.sum(jnp.where(jnp.asarray(real)[:, None],
                                 out.reshape(len(real), -1), 0.0) ** 2), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(s),
                                               jnp.asarray(box))
    ts = torch.tensor(s).requires_grad_(True)
    tb = torch.tensor(box).requires_grad_(True)
    t_out = pair_radial_aev(ts, tb, *args)
    rows = t_out.reshape(len(real), -1)[torch.tensor(real)]
    t_grads = torch.autograd.grad(rows.square().sum(), (ts, tb))
    t_out = t_out.detach().numpy().reshape(len(real), -1)
    j_out = np.asarray(j_out).reshape(len(real), -1)
    np.testing.assert_allclose(t_out[real], j_out[real], rtol=1e-5,
                               atol=1e-6 * np.abs(j_out[real]).max())
    for name, tg, jg in zip(('dslots', 'dbox'), t_grads, j_grads):
        tg, jg = tg.numpy(), np.asarray(jg)
        np.testing.assert_allclose(tg, jg, rtol=1e-4,
                                   atol=1e-5 * np.abs(jg).max(), err_msg=name)


def test_pair_step_matches_jax(system):
    water, jp, tp, _, pair, cl, pos, box = system
    jm = dataclasses.replace(JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN), window_radial='pair')
    jcl = jm.create_cell_list(water.box, skin=SKIN)
    jpos, jbox = jnp.asarray(water.positions), jnp.asarray(water.box)
    jsel = jax.jit(jm.select, static_argnums=(2,))(jpos, jbox, jcl)
    je, jf = jax.jit(jm.energy_and_forces_from_selection,
                     static_argnums=(3,))(jp, jpos, jbox, jcl, jsel)
    sel = pair.select(pos, box, cl)
    assert tuple(sel.shift_planes.shape) == (1, 1, 1)   # none built
    te, tf = pair.energy_and_forces_from_selection(tp, pos, box, cl, sel)
    jf = np.asarray(jf)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=2e-4,
                               atol=2e-5 * np.abs(jf).max())


def test_pair_step_matches_window_step(system):
    _, _, tp, window, pair, cl, pos, box = system
    e1, f1 = window.energy_and_forces_from_selection(
        tp, pos, box, cl, window.select(pos, box, cl))
    e2, f2 = pair.energy_and_forces_from_selection(
        tp, pos, box, cl, pair.select(pos, box, cl))
    np.testing.assert_allclose(float(e2), float(e1), rtol=1e-6)
    np.testing.assert_allclose(f2.numpy(), f1.numpy(), rtol=1e-4,
                               atol=2e-6 * float(f1.abs().max()))


def test_pair_cpu_dispatch_is_plain(system, slots):
    basis = system[3].basis
    s, grid, caps = slots
    ins = pair_inputs(s, system[7], grid, caps)
    args = (*basis_args(basis), grid, caps, basis.torchani)
    for got, want in zip(pair_radial(*ins, *args),
                         pair_radial_plain(*ins, *args)):
        assert torch.equal(got, want)


def test_window_radial_needs_shift_planes(system):
    """A selection built for the pair kernel has no shift planes, and the
    directed window kernel refuses it, as in the JAX package."""
    _, _, tp, window, pair, cl, pos, box = system
    sel = pair.select(pos, box, cl)
    with pytest.raises(ValueError, match='need_shift_planes'):
        window.energy_and_forces_from_selection(tp, pos, box, cl, sel)


def test_pair_runs_match_geometry(system, slots):
    """The kernel's run table (``cuda_zpair.pair_runs``) against
    ``PairGeometry``: the z-runs tile the z-triple lanes in order,
    species-major, at most 32 lanes each; run (s, dz) holds species s's
    slots of z-cell dz in rank order inside s's lane block, and every row's
    self lane lies in a run of its species' middle z-cell. On water(150)'s
    pair selection the occupied lanes lead every run (the slots fill by
    rank), so the kernel, which cuts each run at its last occupied lane,
    tests no empty lane."""
    s, grid, caps = slots
    geo = PairGeometry(grid, caps)
    first, length, species = pair_runs(geo)
    assert first[0] == 0 and (first[1:] == first[:-1] + length[:-1]).all()
    assert first[-1] + length[-1] == geo.ll
    assert (length >= 1).all() and (length <= 32).all()
    assert (np.diff(species) >= 0).all()
    for sp, ((lo, hi), cs) in enumerate(zip(geo.lane_bounds, caps)):
        mine = species == sp
        assert first[mine].min() == lo and (first + length)[mine].max() == hi
        assert length[mine].sum() == 3 * cs
        for dz in range(3):
            z0 = lo + dz * cs
            runs = mine & (first >= z0) & (first < z0 + cs)
            assert first[runs].min() == z0 and length[runs].sum() == cs
        rows = np.arange(geo.row_off[sp], geo.row_off[sp + 1])
        ends = first + length
        for lane in geo.self_lane[rows]:
            k = np.flatnonzero((first <= lane) & (lane < ends))
            assert len(k) == 1 and species[k[0]] == sp
            assert lo + cs <= first[k[0]] and ends[k[0]] <= lo + 2 * cs
    _, z3, _ = pair_inputs(s, system[7], grid, caps)
    occ = (z3[:, 0, :] < EMPTY_ROW).numpy()
    assert (~occ).any() and occ.any()
    for f, n in zip(first, length):
        run = occ[:, f:f + n]
        assert not (run[:, 1:] & ~run[:, :-1]).any()
