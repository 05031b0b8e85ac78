"""The port's window path (``ANIModel.with_blocked_layout(impl='window')``)
against the JAX package's on water(150): the frozen selection (tier row
order, neighbor keys, masks, slot maps) and every overflow count exactly,
``window_features`` and the force step at the JAX suite's own window
gates. Then the ports of the JAX suite's window tests (sticky reuse, wrap
invariance, overflow detection, bucketing and three-tier parity), the
untiered branch, and a triclinic and a wrapped-position case against the
port's own 'pallas' step, which ``test_torch_ani_slice.py`` holds against
JAX."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.neighbors.window import window_features as j_features
from nnpops_tpu_torch.config import ANIBasis as TBasis
from nnpops_tpu_torch.models.ani import ANIModel as TModel
from nnpops_tpu_torch.neighbors.window import WindowSelection, window_features
from nnpops_tpu_torch.params import from_jax_params
from nnpops_tpu_torch.utils import make_triclinic_water_box, make_water_box

SKIN = 0.25
MARGIN = 1.15
CONFIGS = {
    # name: (nn_impl, nn_dtype)
    'f32-xla': ('xla', None),
    'bf16-fused': ('fused', 'bfloat16'),
}


@pytest.fixture(scope='module')
def system():
    water = make_water_box(150, seed=0)
    jp = j_init(jax.random.PRNGKey(0), JBasis.ani2x(),
                layer_dims=[(32, 24, 16)] * 7, num_models=2)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device='cpu')
    return water, jp, tp


def t_model(water, nn_impl='xla', nn_dtype=None, impl='window', skin=SKIN):
    return TModel.from_atomic_numbers(
        water.atomic_numbers, TBasis.ani2x(), nn_impl=nn_impl,
        nn_dtype=nn_dtype).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl=impl, skin=skin)


@pytest.fixture(scope='module')
def jax_side(system):
    """The JAX window models, cell list and one jitted selection (the
    selection does not depend on the ensemble's configuration)."""
    water, _, _ = system
    models = {name: JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x(), nn_impl=nn_impl,
        nn_dtype=nn_dtype).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN)
        for name, (nn_impl, nn_dtype) in CONFIGS.items()}
    jm = models['f32-xla']
    jcl = jm.create_cell_list(water.box, skin=SKIN)
    jpos, jbox = jnp.asarray(water.positions), jnp.asarray(water.box)
    jsel = jax.jit(jm.select, static_argnums=(2,))(jpos, jbox, jcl)
    return models, jcl, jsel


@pytest.fixture(scope='module')
def port_side(system):
    water, _, _ = system
    tm = t_model(water)
    tcl = tm.create_cell_list(water.box, skin=SKIN)
    tpos, tbox = torch.tensor(water.positions), torch.tensor(water.box)
    return tm, tcl, tpos, tbox, tm.select(tpos, tbox, tcl)


def assert_equal(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, name)


def test_selection_matches_jax(system, jax_side, port_side):
    water, _, _ = system
    models, jcl, js = jax_side
    tm, tcl, tpos, tbox, ts = port_side
    assert isinstance(ts, WindowSelection) and ts.tier is not None
    for f in ('order', 'slot_of_sorted', 'inv_order', 'slot_to_atom',
              'nbr_rad', 'rad_mask', 'max_rad', 'max_ang',
              'max_cell_occupancy', 'ang_in_rad'):
        assert_equal('ang.' + f, getattr(ts.ang, f), getattr(js.ang, f))
    for f in ('rad_order', 'rad_slot_of_sorted', 'rad_slot_of_atom',
              'rad_slot_to_atom', 'cell_perm', 'n_big_true', 'max_cell_sp',
              'max_cell_sp_ang'):
        assert_equal(f, getattr(ts, f), getattr(js, f))
    for f in ('row_order', 'row_atom', 'tier_counts', 'concat_pos'):
        assert_equal('tier.' + f, getattr(ts.tier, f), getattr(js.tier, f))
    assert len(ts.tier.idx) == len(js.tier.idx) == 3
    for t in range(len(js.tier.idx)):
        for f in ('idx', 'mask', 'slot_rows'):
            assert_equal(f'tier.{f}[{t}]', getattr(ts.tier, f)[t],
                         getattr(js.tier, f)[t])
    np.testing.assert_allclose(ts.wrap_shift.numpy(), np.asarray(js.wrap_shift),
                               atol=1e-5)
    np.testing.assert_allclose(ts.shift_planes.numpy(),
                               np.asarray(js.shift_planes), atol=1e-5)
    jpos, jbox = jnp.asarray(water.positions), jnp.asarray(water.box)
    jc = models['f32-xla'].overflow_counts(jpos, jbox, jcl, js)
    tc = tm.overflow_counts(tpos, tbox, tcl, ts)
    assert sorted(tc) == sorted(jc) == sorted(
        ['max_neighbors', 'max_cell_occupancy', 'max_cell_occupancy_ang',
         'max_angular', 'ang_tier_rows'])
    for k in jc:
        assert_equal(k, tc[k], jc[k])
    tm.check_overflow(tpos, tbox, tcl, ts)


def test_window_features_match_jax(system, jax_side, port_side):
    water, _, _ = system
    models, jcl, js = jax_side
    tm, tcl, tpos, tbox, ts = port_side
    jm = models['f32-xla']
    feat_fn = jax.jit(lambda p, b, s: j_features(
        jcl, p, b, s, jm.basis, jm.blocked_layout,
        atom_order=jnp.asarray(jm.grouping.order)))
    want = np.asarray(feat_fn(jnp.asarray(water.positions),
                              jnp.asarray(water.box), js))
    order, _ = tm._device_arrays(tpos.device)
    got = window_features(tcl, tpos, tbox, ts, tm.basis, tm.blocked_layout,
                          atom_order=order).numpy()
    assert got.shape == want.shape == (tm.num_atoms, tm.basis.aev_length)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_step_matches_jax(system, jax_side, port_side, name):
    water, jp, tp = system
    models, jcl, js = jax_side
    _, tcl, tpos, tbox, ts = port_side
    tm = t_model(water, *CONFIGS[name])
    jstep = jax.jit(models[name].energy_and_forces_from_selection,
                    static_argnums=(3,))
    je, jf = jstep(jp, jnp.asarray(water.positions), jnp.asarray(water.box),
                   jcl, js)
    te, tf = tm.energy_and_forces_from_selection(tp, tpos, tbox, tcl, ts)
    je, jf, te, tf = float(je), np.asarray(jf), float(te), tf.numpy()
    assert tf.shape == (tm.num_atoms, 3)
    scale = np.abs(jf).max()
    if name == 'f32-xla':
        np.testing.assert_allclose(te, je, rtol=1e-5)
        np.testing.assert_allclose(tf, jf, rtol=2e-4, atol=2e-5 * scale)
    else:
        np.testing.assert_allclose(te, je, rtol=1e-4)
        assert np.abs(tf - jf).max() <= 5e-3 * scale
    with torch.no_grad():
        e_only = tm.energy_from_selection(tp, tpos, tbox, tcl, ts)
    np.testing.assert_allclose(float(e_only), te, rtol=1e-6)


def step(model, params, pos, box, skin=SKIN):
    """Select and step, as ``energy_and_forces_fused`` does in JAX."""
    cl = model.create_cell_list(box.numpy(), skin=skin)
    sel = model.select(pos, box, cl)
    e, f = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    return float(e), f.numpy()


def assert_step_close(got, want, e_rtol, f_rtol, f_atol_rel):
    (e1, f1), (e2, f2) = got, want
    np.testing.assert_allclose(e1, e2, rtol=e_rtol)
    np.testing.assert_allclose(f1, f2, rtol=f_rtol,
                               atol=f_atol_rel * np.abs(f2).max())


def test_window_sticky_selection_reuse(system):
    """A frozen selection stays valid for positions drifted within the
    Verlet-skin contract (``test_window_aev.py``'s sticky test)."""
    water, _, tp = system
    skin = 0.3
    model = t_model(water, skin=skin)
    cl = model.create_cell_list(water.box, skin=skin)
    pos, box = torch.tensor(water.positions), torch.tensor(water.box)
    sel = model.select(pos, box, cl)
    rng = np.random.RandomState(5)
    drift = (rng.uniform(-1, 1, water.positions.shape)
             * (skin / 2 / np.sqrt(3)) * 0.9).astype(np.float32)
    pos2 = pos + torch.tensor(drift)
    e_frozen, f_frozen = model.energy_and_forces_from_selection(
        tp, pos2, box, cl, sel)
    assert_step_close((float(e_frozen), f_frozen.numpy()),
                      step(model, tp, pos2, box, skin), 1e-5, 2e-4, 2e-5)


def test_window_wrap_invariance(system, port_side):
    """Moving atoms by whole box vectors changes nothing: the frozen
    ``wrap_shift`` wraps them back into the primary box."""
    water, _, tp = system
    tm, _, pos, box, _ = port_side
    rng = np.random.RandomState(3)
    shifts = rng.randint(-2, 3, water.positions.shape).astype(np.float32)
    pos2 = pos + torch.tensor(shifts) @ box
    assert_step_close(step(tm, tp, pos2, box), step(tm, tp, pos, box),
                      1e-6, 1e-3, 1e-4)


def test_window_overflow_detected(system, port_side):
    water, _, _ = system
    tm, _, pos, box, _ = port_side
    small = dataclasses.replace(tm.blocked_layout, cell_caps=(4, 4))
    tiny = dataclasses.replace(tm, blocked_layout=small)
    cl = tiny.create_cell_list(water.box, skin=SKIN)
    with pytest.raises(RuntimeError, match='max_cell_occupancy'):
        tiny.check_overflow(pos, box, cl)


def test_window_cell_bucketing_parity(system, port_side):
    """Forcing the two-class (big/small occupancy) radial kernel split
    changes nothing. The small-class caps are one under the median
    per-(cell, species) occupancy, so both classes hold real atoms."""
    water, _, tp = system
    tm, _, pos, box, _ = port_side
    cl = tm.create_cell_list(water.box, skin=SKIN)
    grid = np.asarray(tm.blocked_layout.cell_grid)
    frac = water.positions.astype(np.float64) @ np.linalg.inv(water.box)
    c3 = np.minimum(((frac - np.floor(frac)) * grid).astype(int), grid - 1)
    cid = (c3[:, 0] * grid[1] + c3[:, 1]) * grid[2] + c3[:, 2]
    occ = np.stack([np.bincount(cid[tm.species_array == s],
                                minlength=cl.num_cells)
                    for s in tm.blocked_layout.present], 1)
    small = tuple(int(x) for x in np.maximum(np.median(occ, 0) - 1, 1))
    is_big = (occ > np.asarray(small)).any(1)
    n_big = int(is_big.sum())
    assert 0 < n_big < cl.num_cells - 2 and occ[~is_big].any()
    bucketed = dataclasses.replace(tm, blocked_layout=dataclasses.replace(
        tm.blocked_layout, small_caps=small, num_big_cells=n_big + 2))
    sel = bucketed.select(pos, box, cl)
    counts = bucketed.overflow_counts(pos, box, cl, sel)
    assert int(counts['num_big_cells']) == n_big
    bucketed.check_overflow(pos, box, cl, sel)
    assert_step_close(step(bucketed, tp, pos, box), step(tm, tp, pos, box),
                      1e-6, 1e-5, 1e-6)


def test_window_three_tier_parity(system, port_side):
    """A forced three-tier angular row ladder (full / mid / small caps)
    matches the 'pallas' step. Tier caps and rows come from brute-force
    angular neighbor counts, so no planned capacity overflows."""
    water, _, tp = system
    tm, _, pos, box, _ = port_side
    layout = tm.blocked_layout
    pos_np = water.positions.astype(np.float64)
    box_np = water.box.astype(np.float64)
    delta = pos_np[None] - pos_np[:, None]
    for ax in (2, 1, 0):
        delta -= np.round(delta[..., ax:ax + 1] / box_np[ax, ax]) * box_np[ax]
    d = np.sqrt((delta ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    sp = tm.species_array
    pres = layout.present
    counts = np.stack([(d[:, sp == pres[i]] < tm.basis.angular_cutoff + SKIN
                        ).sum(1) for i in range(len(pres))], axis=1)
    caps = np.asarray(layout.ang_caps)
    mid = np.minimum(np.ceil(np.percentile(counts, 85, axis=0)).astype(int)
                     + 1, caps - 1)
    small = np.maximum(np.minimum(np.ceil(np.percentile(
        counts, 50, axis=0)).astype(int) + 1, mid - 1), 1)
    mid = np.maximum(mid, small)
    t_of = (counts <= mid).all(1).astype(int) + (counts <= small).all(1)
    rows, cum = [], np.zeros(len(pres), np.int64)
    for t in (0, 1):
        r = np.array([max(int(((t_of == t) & (sp == pres[i])).sum()), 1) + 4
                      for i in range(len(pres))])
        r = np.maximum(np.minimum(r, np.array(
            [(sp == pres[i]).sum() for i in range(len(pres))]) - cum - 1), 0)
        rows.append(tuple(int(x) for x in r))
        cum += r
    tiered = dataclasses.replace(tm, blocked_layout=dataclasses.replace(
        layout, ang_tier_caps=(tuple(int(x) for x in mid),
                               tuple(int(x) for x in small)),
        ang_tier_rows=tuple(rows)))
    cl = tiered.create_cell_list(water.box, skin=SKIN)
    tiered.check_overflow(pos, box, cl)
    pallas = t_model(water, impl='pallas')
    assert_step_close(step(tiered, tp, pos, box), step(pallas, tp, pos, box),
                      1e-5, 2e-4, 2e-5)


def test_untiered_window_matches_tiered(system, port_side):
    """Without planned tiers the angular rows run as one block through the
    payload gather (the untiered branch)."""
    water, _, tp = system
    tm, _, pos, box, _ = port_side
    flat = dataclasses.replace(tm, blocked_layout=dataclasses.replace(
        tm.blocked_layout, ang_tier_caps=None, ang_tier_rows=None))
    cl = flat.create_cell_list(water.box, skin=SKIN)
    assert flat.select(pos, box, cl).tier is None
    assert_step_close(step(flat, tp, pos, box), step(tm, tp, pos, box),
                      1e-6, 1e-4, 1e-5)


def test_window_triclinic_matches_pallas(system):
    """A reduced triclinic box stays on the window path and matches the
    min-image 'pallas' step."""
    _, _, tp = system
    water = make_triclinic_water_box(300, seed=0)
    window = t_model(water)
    assert window.aev_impl == 'window'
    pallas = t_model(water, impl='pallas')
    pos, box = torch.tensor(water.positions), torch.tensor(water.box)
    assert_step_close(step(window, tp, pos, box), step(pallas, tp, pos, box),
                      1e-5, 2e-4, 2e-5)


def test_window_wrapped_positions_match_pallas(system, port_side):
    """Atoms translated out of the primary box (a nonzero frozen
    ``wrap_shift``) still match the 'pallas' step tightly."""
    water, _, tp = system
    tm, _, pos, box, _ = port_side
    pos2 = pos - 0.37 * torch.diagonal(box)[None, :]
    pallas = t_model(water, impl='pallas')
    assert_step_close(step(tm, tp, pos2, box), step(pallas, tp, pos2, box),
                      1e-5, 2e-4, 2e-5)


def test_other_window_radial_kernels_raise(system, port_side):
    """The 'pair' and 'cluster' switches build the JAX package's
    configuration: replacing ``window_radial`` selects without shift planes
    (pair) or asks for a cluster selection (cluster); at water(150) the
    cluster planner refuses the box and ``with_blocked_layout`` keeps
    'window', as JAX does. An unknown kernel name raises."""
    water, _, _ = system
    tm, tcl, tpos, tbox, _ = port_side
    pair = dataclasses.replace(tm, window_radial='pair')
    assert tuple(pair.select(tpos, tbox, tcl).shift_planes.shape) == (1, 1, 1)
    cluster = dataclasses.replace(tm, window_radial='cluster')
    assert cluster.select(tpos, tbox, tcl).clusters is None   # no plan
    kept = t_model(water).with_blocked_layout(water.positions, water.box,
                                              margin=MARGIN, impl='window',
                                              skin=SKIN,
                                              radial_impl='cluster')
    jkept = JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN, radial_impl='cluster')
    assert kept.window_radial == jkept.window_radial == 'window'
    assert kept.blocked_layout.cluster_plan is None
    with pytest.raises(ValueError, match='window_radial'):
        dataclasses.replace(tm, window_radial='dense')
