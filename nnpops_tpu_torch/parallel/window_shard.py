"""The window pipeline sharded over a mesh axis (port of
``nnpops_tpu.parallel.window_shard``): the main path's kernels, with the
heavy stages split over the ranks of the axis.

* Radial: a replicated slot build and 27-cell window (bandwidth only),
  then each rank runs the window radial kernel (B.2, ``ops.cuda_window``)
  on its contiguous block of ``nc_b`` cells. The tail block is padded
  with FAR cells, whose rows come out exact zeros. The blocks are
  all-gathered in rank order, so every rank reads its atoms' rows.
* Angular + NN: each species segment of each tier's rows is split into
  equal (padded) sub-blocks over the ranks, so every rank's rows have a
  static species layout: the angular kernel (B.3, ``ops.cuda_aev``) runs
  once per tier on them, then the species networks on static row slices.
  Padded rows carry the fill slot ``cc_a + 1`` (a zero position) and are
  masked out of the energy.
* The self energies enter on rank 0 only; an all-reduce sums the ranks'
  energies. Positions enter replicated, so forces come by autograd on every
  rank, and the kernels' backward launches run too.

As in the JAX package, cell-occupancy bucketing is not used here (its
frozen cell permutation does not commute with contiguous cell blocks):
every cell runs at full caps. The species networks are the f32 (or bf16)
PyTorch ensemble, ``ops.batched_nn.apply_species_net``, the ensemble the
JAX sharded path evaluates.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.ani import ANIModel, ANIParams
from ..neighbors.blocked import BlockedLayout
from ..neighbors.window import (WindowSelection, _expand_radial_rows,
                                _grid_device_tables, _part_deltas,
                                _radial_slots, _tier_rows_static,
                                tier_layouts)
from ..ops.batched_nn import apply_species_net
from ..ops.cuda_aev import angular_aev
from ..ops.cuda_window import FAR, window_radial
from .collectives import all_gather_rows, psum, replicated
from .sharding import mesh_axis, replicated_params

Tensor = torch.Tensor


def _ceil_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def window_sharded_energy(model: ANIModel, mesh: DeviceMesh,
                          axis: str = 'dp') -> Callable:
    """Build ``fn(params, positions, box, sel) -> energy`` over
    ``mesh[axis]`` (positions replicated, the energy summed over the
    ranks; differentiable, forces by autograd).

    ``model`` must be window mode (``with_blocked_layout(impl='window')``,
    with angular tiers) and ``sel`` a :class:`WindowSelection` from
    ``model.select`` with the window radial's image shifts (the default
    ``window_radial='window'``)."""
    if model.aev_impl != 'window':
        raise ValueError('window_sharded_energy needs a window-mode model')
    layout: BlockedLayout = model.blocked_layout
    if layout.ang_tier_rows is None:
        raise ValueError('window_sharded_energy requires angular tiering '
                         '(layout.ang_tier_rows); plan with '
                         'with_blocked_layout(impl="window")')
    group, d, dsz = mesh_axis(mesh, axis)
    basis = model.basis
    cell_caps = tuple(int(x) for x in layout.cell_caps)
    c = sum(cell_caps)
    cell_grid = tuple(int(x) for x in layout.cell_grid)
    ncells = int(np.prod(cell_grid))
    cc = ncells * c
    num_r = basis.num_radial
    npres = len(layout.present)
    # Cells per rank; the tail block is padded with FAR cells.
    nc_b = _ceil_to(ncells, dsz) // dsz
    if layout.ang_cell_grid is not None and layout.ang_cell_caps is not None:
        cc_a = int(np.prod(layout.ang_cell_grid)) * sum(layout.ang_cell_caps)
    else:
        cc_a = cc
    fill = cc_a + 1

    # Static tier segmentation: per tier, the rows of species 0 .. P-1,
    # each segment split into dsz equal (padded) sub-blocks.
    g = model.grouping
    present_counts = tuple(int(g.counts[s]) for s in layout.present)
    tier_rows = _tier_rows_static(present_counts, layout.ang_tier_rows)
    ntiers = len(tier_rows)
    tier_starts = [np.cumsum((0,) + tuple(tr))[:-1] for tr in tier_rows]
    tier_sub = [tuple(_ceil_to(r, dsz) // dsz for r in tr)
                for tr in tier_rows]
    # row_atom is species-major, tier-sorted within a species: species i's
    # tier-t rows start at off_all[i] + cum_rows[t][i].
    cum_rows = np.zeros((ntiers + 1, npres), np.int64)
    for t in range(ntiers):
        cum_rows[t + 1] = cum_rows[t] + np.asarray(tier_rows[t])
    off_all = np.cumsum((0,) + present_counts)[:-1]
    tier_lays = tier_layouts(layout)

    def seg(x: Tensor, start: int, count: int, sub: int, fill_value):
        """This rank's padded sub-block of rows [start, start + count)."""
        lo = min(d * sub, count)
        hi = min((d + 1) * sub, count)
        part = x[start + lo:start + hi]
        if hi - lo < sub:
            pad = part.new_full((sub - (hi - lo),) + tuple(x.shape[1:]),
                                fill_value)
            part = torch.cat([part, pad])
        return part

    def species_energy(params: ANIParams, feat: Tensor, sub_counts,
                       valid: Tensor) -> Tensor:
        """The networks over a static species-blocked row layout; masked
        rows contribute zero."""
        total = feat.new_zeros(())
        off = 0
        for i, cnt in enumerate(sub_counts):
            net = params.ensemble.networks[layout.present[i]]
            e_i = torch.mean(apply_species_net(net, feat[off:off + cnt],
                                               model.nn_compute_dtype), -1)
            total = total + torch.sum(torch.where(valid[off:off + cnt], e_i,
                                                  0.0))
            off += cnt
        return total

    def fn(params: ANIParams, positions: Tensor, box: Tensor,
           sel: WindowSelection) -> Tensor:
        if sel.shift_planes.shape[1] != ncells:
            raise ValueError('window_sharded_energy needs a selection built '
                             'with need_shift_planes=True')
        params = replicated_params(params, group)
        positions = replicated(positions, group)
        dev = positions.device
        t = sel.tier

        # ---- Radial: replicated slot build, this rank's cell block.
        slots = _radial_slots(positions, sel)                    # [cc, 3]
        _, cand_slot = _grid_device_tables(cell_grid, cell_caps, dev)
        win = (slots.t().index_select(1, cand_slot.reshape(-1))
               .reshape(3, ncells, cand_slot.shape[1]) + sel.shift_planes)
        centers = slots.reshape(ncells, c, 3)
        lo, hi = min(d * nc_b, ncells), min((d + 1) * nc_b, ncells)
        win_b, ctr_b = win[:, lo:hi], centers[lo:hi]
        if hi - lo < nc_b:
            pad = nc_b - (hi - lo)
            win_b = torch.cat([win_b, win_b.new_full(
                (3, pad, win_b.shape[2]), FAR)], 1)
            ctr_b = torch.cat([ctr_b, ctr_b.new_full((pad, c, 3), FAR)])
        rad_b = window_radial(win_b[0], win_b[1], win_b[2], ctr_b,
                              basis.radial_cutoff, basis.radial_eta,
                              basis.radial_rs, cell_caps,
                              basis.torchani)                 # [nc_b, c, P*R]
        rad_all = all_gather_rows(rad_b, group)
        rad_flat = rad_all.reshape(nc_b * dsz * c, npres * num_r)

        # ---- Angular: this rank's tier row blocks.
        sa = sel.ang
        slots_a = positions.new_zeros(cc_a + 2, 3).index_copy(
            0, sa.slot_of_sorted, positions.index_select(0, sa.order))
        total = positions.new_zeros(())
        for ti in range(ntiers):
            starts, counts, subs = tier_starts[ti], tier_rows[ti], tier_sub[ti]
            idx = torch.cat([seg(t.idx[ti], int(starts[i]), counts[i],
                                 subs[i], fill) for i in range(npres)])
            mask = torch.cat([seg(t.mask[ti], int(starts[i]), counts[i],
                                  subs[i], False) for i in range(npres)])
            srows = torch.cat([seg(t.slot_rows[ti], int(starts[i]),
                                   counts[i], subs[i], fill)
                               for i in range(npres)])
            atoms = torch.cat([seg(t.row_atom,
                                   int(off_all[i] + cum_rows[ti][i]),
                                   counts[i], subs[i], 0)
                               for i in range(npres)])
            gathered = slots_a.index_select(0, idx.reshape(-1)).reshape(
                idx.shape[0], idx.shape[1], 3)
            deltas = _part_deltas(gathered, slots_a.index_select(0, srows),
                                  mask, box)
            ang = angular_aev(deltas, mask, basis, tier_lays[ti],
                              deltas.shape[2])
            # ---- The full AEV rows and the networks on static layouts.
            row_slots = torch.clamp(sel.rad_slot_of_atom[atoms], max=cc - 1)
            feat = _expand_radial_rows(rad_flat.index_select(0, row_slots),
                                       ang, layout, basis)
            total = total + species_energy(params, feat, subs, srows < fill)
        if d == 0:
            _, species = model._device_arrays(dev)
            total = total + torch.sum(params.self_energies[species])
        return psum(total, group)

    return fn
