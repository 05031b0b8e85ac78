"""Species-blocked planning, selection and payload of the PyTorch port
against nnpops_tpu.neighbors.blocked (cell path on water(150), dense path
on water(48), a triclinic box, wrapped positions, forced overflow)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis
from nnpops_tpu.neighbors import blocked as jb
from nnpops_tpu.neighbors.cell_list import CellList as JCellList
from nnpops_tpu.utils.water import make_triclinic_water_box, make_water_box
from nnpops_tpu_torch.neighbors import blocked as tb
from nnpops_tpu_torch.neighbors.cell_list import CellList as TCellList

BASIS = ANIBasis.ani2x()
SKIN = 0.25
RC, RA = BASIS.radial_cutoff, BASIS.angular_cutoff
SPECIES_OF_Z = {1: 0, 8: 3}


def _system(kind):
    if kind == 'cells':
        return make_water_box(150, seed=0)
    if kind == 'dense':
        return make_water_box(48, seed=0)
    return make_triclinic_water_box(300, seed=1)


def _plans(water, margin=1.2):
    species = np.array([SPECIES_OF_Z[z] for z in water.atomic_numbers], np.int32)
    args = (water.positions, water.box, species, RC + SKIN, RA + SKIN,
            BASIS.num_species)
    return species, jb.plan_blocked_layout(*args, margin=margin), \
        tb.plan_blocked_layout(*args, margin=margin)


def _select(water, species, jlay, tlay, positions=None, cell_capacity=None):
    pos = water.positions if positions is None else positions
    jcl = JCellList.create(water.box, RC + SKIN, capacity=jlay.rad_total,
                           cell_capacity=cell_capacity)
    tcl = TCellList.create(water.box, RC + SKIN, capacity=tlay.rad_total,
                           cell_capacity=cell_capacity)
    assert dataclasses.asdict(jcl) == dataclasses.asdict(tcl)
    jsel = jb.select_blocked(jcl, jnp.asarray(pos), jnp.asarray(water.box),
                             species, jlay, RC, RA)
    tsel = tb.select_blocked(tcl, torch.tensor(pos), torch.tensor(water.box),
                             species, tlay, RC, RA)
    return jcl, tcl, jsel, tsel


@pytest.fixture(scope='module', params=['cells', 'dense', 'triclinic'])
def selected(request):
    water = _system(request.param)
    species, jlay, tlay = _plans(water)
    return (request.param, water, species, jlay, tlay) + _select(
        water, species, jlay, tlay)


def _lane_atoms(sel, nbr, mask, n):
    """[N, K] neighbor atom id per lane, rows in original atom order
    (-1 on padding)."""
    s2a = np.asarray(sel.slot_to_atom)
    atoms = np.where(np.asarray(mask), s2a[np.asarray(nbr)], -1)
    return atoms[np.asarray(sel.inv_order)]


@pytest.mark.parametrize('margin', [1.0, 1.15, 1.2])
@pytest.mark.parametrize('kind', ['cells', 'dense', 'triclinic'])
def test_plan_matches_jax_field_by_field(kind, margin):
    water = _system(kind)
    _, jlay, tlay = _plans(water, margin)
    for f in dataclasses.fields(tlay):
        assert getattr(tlay, f.name) == getattr(jlay, f.name), f.name
    for f in dataclasses.fields(jlay):
        if not hasattr(tlay, f.name):
            assert getattr(jlay, f.name) is None, f.name   # window-only fields
    for prop in ('rad_total', 'ang_total', 'rad_offsets', 'ang_offsets'):
        assert getattr(tlay, prop) == getattr(jlay, prop)


def test_selection_matches_jax(selected):
    kind, water, species, jlay, tlay, jcl, tcl, jsel, tsel = selected
    assert tcl.use_cells == (kind != 'dense')
    n = len(species)
    for name in ('max_rad', 'max_ang', 'max_cell_occupancy'):
        np.testing.assert_array_equal(getattr(tsel, name).numpy(),
                                      np.asarray(getattr(jsel, name)), name)
    for nbr, mask in (('nbr_rad', 'rad_mask'), ('nbr_ang', 'ang_mask')):
        want = _lane_atoms(jsel, getattr(jsel, nbr), getattr(jsel, mask), n)
        got = _lane_atoms(tsel, getattr(tsel, nbr).numpy(),
                          getattr(tsel, mask).numpy(), n)
        # Per row and species block, the same neighbors (here even in the
        # same lanes: slot-id order within each angular-first block).
        np.testing.assert_array_equal(got, want, nbr)
        lanes = tlay.rad_offsets if nbr == 'nbr_rad' else tlay.ang_offsets
        caps = tlay.rad_caps if nbr == 'nbr_rad' else tlay.ang_caps
        for s, off, cap in zip(tlay.present, lanes, caps):
            blk = got[:, off:off + cap]
            assert (species[blk[blk >= 0]] == s).all()
    np.testing.assert_array_equal(tsel.ang_in_rad.numpy()[tsel.inv_order.numpy()],
                                  np.asarray(jsel.ang_in_rad)[np.asarray(jsel.inv_order)])
    assert not bool(tsel.did_overflow(tlay, tcl.cell_capacity))


@pytest.mark.parametrize('selected', ['cells', 'dense'], indirect=True)
def test_forced_overflow_counts_match_jax(selected):
    """Capacities one below the true counts: the selection truncates, and
    the overflow counts (the soft-failure contract) still equal JAX's."""
    kind, water, species, jlay, tlay, jcl, tcl, jsel, tsel = selected
    max_rad = np.asarray(jsel.max_rad)
    max_ang = np.asarray(jsel.max_ang)
    shrink = dict(rad_caps=tuple(int(c) - 1 for c in max_rad),
                  ang_caps=tuple(int(c) - 1 for c in max_ang))
    jl2 = dataclasses.replace(jlay, **shrink)
    tl2 = dataclasses.replace(tlay, **shrink)
    occ = int(jsel.max_cell_occupancy)
    cap = occ - 1 if kind != 'dense' else None
    _, tcl2, js2, ts2 = _select(water, species, jl2, tl2, cell_capacity=cap)
    for name in ('max_rad', 'max_ang', 'max_cell_occupancy'):
        np.testing.assert_array_equal(getattr(ts2, name).numpy(),
                                      np.asarray(getattr(js2, name)), name)
    assert bool(ts2.did_overflow(tl2, tcl2.cell_capacity))
    n = len(species)
    got = _lane_atoms(ts2, ts2.nbr_rad.numpy(), ts2.rad_mask.numpy(), n)
    want = _lane_atoms(js2, js2.nbr_rad, js2.rad_mask, n)
    np.testing.assert_array_equal(got, want)


def _payloads(jcl, tcl, jsel, tsel, layouts, pos, box, **kw):
    jp = jb.payload_from_blocked(jcl, jnp.asarray(pos), jnp.asarray(box), jsel,
                                 mirror_vjp=False, layout=layouts[0], **kw)
    tp = tb.payload_from_blocked(tcl, torch.tensor(pos), torch.tensor(box),
                                 tsel, layout=layouts[1], **kw)
    return jp, tp


def test_payload_matches_jax(selected):
    kind, water, species, jlay, tlay, jcl, tcl, jsel, tsel = selected
    jp, tp = _payloads(jcl, tcl, jsel, tsel, (jlay, tlay), water.positions,
                       water.box)
    for name in ('rad_deltas', 'rad_r', 'ang_deltas', 'ang_r'):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    for name in ('rad_mask', 'ang_mask'):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    # Rad-only mode with a species-grouped row order.
    order = np.argsort(species, kind='stable')
    io_j = np.asarray(jsel.inv_order)[order]
    io_t = tsel.inv_order[torch.as_tensor(order)]
    jr = jb.payload_from_blocked(jcl, jnp.asarray(water.positions),
                                 jnp.asarray(water.box), jsel, mirror_vjp=False,
                                 rad_only=True, row_order=jnp.asarray(io_j))
    tr = tb.payload_from_blocked(tcl, torch.tensor(water.positions),
                                 torch.tensor(water.box), tsel, rad_only=True,
                                 row_order=io_t)
    assert tr.ang_deltas is None and tr.ang_r is None
    np.testing.assert_allclose(tr.rad_deltas.numpy(), np.asarray(jr.rad_deltas),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tr.ang_in_rad.numpy(), np.asarray(jr.ang_in_rad))


def test_payload_wrapped_positions_match_jax(selected):
    """Atoms moved by whole box vectors: the same minimum-image deltas as
    JAX on the same wrapped input, and as the unwrapped payload."""
    kind, water, species, jlay, tlay, jcl, tcl, jsel, tsel = selected
    rng = np.random.RandomState(3)
    shifts = rng.randint(-1, 2, (len(species), 3)).astype(np.float32)
    pos2 = (water.positions + shifts @ water.box).astype(np.float32)
    jp, tp = _payloads(jcl, tcl, jsel, tsel, (jlay, tlay), pos2, water.box)
    np.testing.assert_allclose(tp.rad_deltas.numpy(), np.asarray(jp.rad_deltas),
                               rtol=0, atol=1e-6)
    _, tp0 = _payloads(jcl, tcl, jsel, tsel, (jlay, tlay), water.positions,
                       water.box)
    np.testing.assert_allclose(tp.rad_deltas.numpy(), tp0.rad_deltas.numpy(),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize('selected', ['cells'], indirect=True)
def test_payload_gradient_is_index_add_adjoint(selected):
    """Autograd through the slot gather (the port's replacement of the JAX
    mirror adjoint) equals the JAX VJP of the same payload."""
    kind, water, species, jlay, tlay, jcl, tcl, jsel, tsel = selected
    import jax
    rng = np.random.RandomState(5)
    w = rng.randn(3, len(species), tlay.rad_total).astype(np.float32)

    def jloss(p):
        pay = jb.payload_from_blocked(jcl, p, jnp.asarray(water.box), jsel,
                                      rad_only=True)
        return jnp.sum(pay.rad_deltas * w) + jnp.sum(pay.rad_r ** 2)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(water.positions)))
    p = torch.tensor(water.positions, requires_grad=True)
    pay = tb.payload_from_blocked(tcl, p, torch.tensor(water.box), tsel,
                                  rad_only=True)
    loss = torch.sum(pay.rad_deltas * torch.tensor(w)) + torch.sum(pay.rad_r ** 2)
    (gt,) = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5, atol=1e-4)
