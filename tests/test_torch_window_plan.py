"""The window path's host planners and static tables against the JAX
package's: layouts planned by ``with_blocked_layout(impl='window')``
(``plan_window_cells``, the dual grid, ``plan_angular_tiers``), the
cell-occupancy bucketing plan at 26,010 atoms, and the stencil, lane and
tier tables. Every output must be equal, not close. The 27-cell window
that the port gathers by the lane table is held against the JAX package's
rolls, forward and adjoint."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.neighbors import window as jw
from nnpops_tpu.utils.water import make_triclinic_water_box, make_water_box
from nnpops_tpu_torch.config import ANIBasis as TBasis
from nnpops_tpu_torch.models.ani import ANIModel as TModel
from nnpops_tpu_torch.neighbors import window as tw

SKIN = 0.25
MARGIN = 1.15
SYSTEMS = {
    'water150': lambda: make_water_box(150, seed=0),
    'water867': lambda: make_water_box(867, seed=0),
    'triclinic300': lambda: make_triclinic_water_box(300, seed=0),
}


def layout_dict(layout):
    d = dataclasses.asdict(layout)
    d.pop('cluster_plan', None)        # the cluster radial path (ROADMAP B.8)
    return d


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_window_layout_equals_jax(name):
    water = SYSTEMS[name]()
    jm = JModel.from_atomic_numbers(water.atomic_numbers, JBasis.ani2x()
                                    ).with_blocked_layout(
        water.positions, water.box, margin=MARGIN, impl='window', skin=SKIN)
    tm = TModel.from_atomic_numbers(water.atomic_numbers, TBasis.ani2x()
                                    ).with_blocked_layout(
        water.positions, water.box, margin=MARGIN, impl='window', skin=SKIN)
    assert jm.aev_impl == tm.aev_impl == 'window'
    jl, tl = jm.blocked_layout, tm.blocked_layout
    assert layout_dict(tl) == layout_dict(jl)
    assert tl.cell_grid is not None and tl.ang_tier_caps is not None
    jcl = jm.create_cell_list(water.box, skin=SKIN)
    tcl = tm.create_cell_list(water.box, skin=SKIN)
    assert dataclasses.asdict(tcl) == dataclasses.asdict(jcl)
    assert tcl.cell_capacity == sum(tl.cell_caps)


def test_bucketing_plan_equals_jax_at_26k():
    """water(8670), the reference's large bench box: the radial grid plans
    cell-occupancy bucketing, and the angular grid and tiers are planned
    too."""
    water = make_water_box(8670, seed=0)
    basis = TBasis.ani2x()
    sp = TModel.from_atomic_numbers(water.atomic_numbers, basis).species_array
    present = tuple(int(s) for s in np.unique(sp))
    plans = []
    for cutoff, pad in ((basis.radial_cutoff + SKIN, 8),
                        (basis.angular_cutoff + SKIN, 1)):
        got = tw.plan_window_cells(water.positions, water.box, sp, present,
                                   cutoff, margin=MARGIN, pad_multiple=pad)
        want = jw.plan_window_cells(water.positions, water.box, sp, present,
                                    cutoff, margin=MARGIN, pad_multiple=pad)
        assert got == want
        plans.append(got)
    _, _, small, n_big = plans[0]
    assert small is not None and n_big is not None      # bucketing is on


def test_angular_tiers_equal_jax_three_ways():
    """``plan_angular_tiers`` on water(867) with the planned angular caps
    and two narrower cap sets (other ladders, other tier counts)."""
    water = make_water_box(867, seed=0)
    basis = TBasis.ani2x()
    tm = TModel.from_atomic_numbers(water.atomic_numbers, basis
                                    ).with_blocked_layout(
        water.positions, water.box, margin=MARGIN, impl='window', skin=SKIN)
    lay = tm.blocked_layout
    for caps in (lay.ang_caps, tuple(c - 4 for c in lay.ang_caps),
                 (24, 12)):
        args = (water.positions, water.box, tm.species_array, lay.present,
                basis.angular_cutoff + SKIN, caps)
        assert tw.plan_angular_tiers(*args) == jw.plan_angular_tiers(*args)


@pytest.mark.parametrize('grid', [(3, 3, 3), (4, 5, 6)])
def test_window_tables_equal_jax(grid):
    f27_t, stencil_t = tw._window_tables(grid)
    f27_j, stencil_j, _ = jw._window_tables(grid)
    np.testing.assert_array_equal(f27_t, f27_j)
    np.testing.assert_array_equal(stencil_t, stencil_j)


@pytest.mark.parametrize('caps', [(20, 12), (13, 8), (7, 3, 5)])
def test_lane_tables_equal_jax(caps):
    for got, want in zip(tw._lane_tables(caps), jw._lane_tables(caps)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('grid, caps', [((3, 3, 3), (20, 12)),
                                        ((4, 5, 3), (3, 2, 4))])
def test_gathered_window_equals_jax_rolls(grid, caps):
    """One ``index_select`` by the lane table builds JAX's species-major
    roll window exactly; its ``index_add`` adjoint is the rolls' adjoint."""
    rng = np.random.RandomState(3)
    ncells, c = int(np.prod(grid)), sum(caps)
    planes = rng.randn(3, ncells, c).astype(np.float32)
    cot = rng.randn(3, ncells, 27 * c).astype(np.float32)
    offs = np.cumsum((0,) + caps)[:-1]

    def j_win(p):
        return jnp.concatenate(
            [jw._make_stencil_window(grid, cs, impl='roll')(
                p[:, :, o:o + cs]) for o, cs in zip(offs, caps)], 2)

    j_out, j_vjp = jax.vjp(j_win, jnp.asarray(planes))
    (j_grad,) = j_vjp(jnp.asarray(cot))
    _, cand_slot = tw._grid_device_tables(grid, caps, torch.device('cpu'))
    slots = torch.tensor(planes).permute(1, 2, 0).reshape(ncells * c, 3)
    slots.requires_grad_(True)
    t_out = slots.t().index_select(1, cand_slot.reshape(-1)).reshape(
        3, ncells, 27 * c)
    (t_grad,) = torch.autograd.grad(t_out, slots, torch.tensor(cot))
    np.testing.assert_array_equal(t_out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_allclose(
        t_grad.reshape(ncells, c, 3).permute(2, 0, 1).numpy(),
        np.asarray(j_grad), rtol=1e-6, atol=1e-5)


def test_tier_tables_equal_jax():
    present_counts = (300, 150)
    planned = ((11, 20), (140, 68))
    rows = tw._tier_rows_static(present_counts, planned)
    assert rows == jw._tier_rows_static(present_counts, planned)
    tot_t, pos_t = tw._tier_static(present_counts, rows)
    tot_j, pos_j = jw._tier_static(present_counts, rows)
    assert tot_t == tot_j
    np.testing.assert_array_equal(pos_t, pos_j)


def test_window_requires_cells():
    """Under 3 cells per axis both packages fall back to 'pallas'."""
    water = make_water_box(8, seed=1)
    jm = JModel.from_atomic_numbers(water.atomic_numbers, JBasis.ani2x()
                                    ).with_blocked_layout(
        water.positions, water.box, impl='window')
    tm = TModel.from_atomic_numbers(water.atomic_numbers, TBasis.ani2x()
                                    ).with_blocked_layout(
        water.positions, water.box, impl='window')
    assert jm.aev_impl == tm.aev_impl == 'pallas'
    assert layout_dict(tm.blocked_layout) == layout_dict(jm.blocked_layout)
