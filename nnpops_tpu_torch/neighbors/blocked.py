"""Species-blocked static neighbor slots (port of
``nnpops_tpu.neighbors.blocked``).

Each atom's neighbor list is packed into static per-species lane ranges
(species block i occupies lanes ``[rad_offsets[i], rad_offsets[i] +
rad_caps[i])``), so the species of every lane is known when the layout is
planned and the per-species AEV reductions are static slice sums. Inside
each species block the lanes order angular-first: neighbors inside the
angular window (slot id ascending), then the other radial neighbors, then
padding. The angular list of species block i is therefore the leading
``ang_caps[i]`` lanes of its radial block.

The selection is frozen for several MD steps (Verlet skin) and runs under
``torch.no_grad()``; only :func:`payload_from_blocked` is differentiable.
Capacity overflow stays observable data (``max_rad``/``max_ang`` per species
and ``max_cell_occupancy``), equal to the JAX counts.

Port notes:

* The JAX selection also builds a ``mirror`` list so that the payload
  gather's adjoint runs as a gather: XLA's scatter-add is slow on the TPU.
  The port omits that field: plain autograd through the index gather is
  the adjoint. The payload gathers use ``index_select``, whose backward is
  an atomic ``index_add``. Advanced indexing (``slots[idx]``) takes
  PyTorch's sort-based accumulating backward instead, which serialises the
  ~100 duplicates of every slot: on an H100 (700 W) at 2,601 atoms the
  slot gather and its adjoint take 14.4 ms that way against 0.17-0.20 ms
  with ``index_select``, where the whole force step takes ~4 ms.
* JAX's ``.at[idx].set(..., mode='drop')`` writes dropped atoms (slot
  ``cc + 1``) out of range on purpose. Torch raises on that, so the port
  allocates the extra rows and slices them off.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import box_transform, minimum_image
from .cell_list import CellList

Tensor = torch.Tensor
_SENTINEL = 2 ** 31 - 1        # int32 key of an invalid candidate


@dataclasses.dataclass(frozen=True)
class BlockedLayout:
    """Static per-species lane layout of a blocked neighbor list.

    present: species ids that occur in the system (static: an MD system's
      species never change; absent species get zero lanes).
    rad_caps / ang_caps: per-present-species lane counts for the radial
      (full-cutoff) and angular (angular-cutoff) neighbor lists.

    Window-mode fields (None unless planned for ``impl='window'``, see
    ``neighbors.window``):
    cell_caps / cell_grid: per-present-species cell-slot capacities of the
      radial grid (species i holds slot ranks [sum(cell_caps[:i]),
      sum(cell_caps[:i+1])) of its cell) and that grid.
    small_caps / num_big_cells: cell-occupancy bucketing; cells whose
      per-species occupancy fits small_caps run the radial kernel with
      packed center rows, at most num_big_cells cells may exceed it.
    ang_tier_caps / ang_tier_rows: angular row tiers; tier t >= 1 has the
      nested smaller caps ang_tier_caps[t-1], ang_tier_rows[t][i] is the
      planned row capacity of tier t for present species i (the last tier
      takes the remaining rows).
    ang_cell_caps / ang_cell_grid: a dedicated angular candidate grid
      (None: share the radial grid).
    cluster_plan: the ``neighbors.clusters.ClusterPlan`` of the
      cluster-pair radial kernel (``radial_impl='cluster'``), else None.
    """
    num_species: int
    present: Tuple[int, ...]
    rad_caps: Tuple[int, ...]
    ang_caps: Tuple[int, ...]
    cell_caps: Optional[Tuple[int, ...]] = None
    cell_grid: Optional[Tuple[int, int, int]] = None
    small_caps: Optional[Tuple[int, ...]] = None
    num_big_cells: Optional[int] = None
    ang_tier_caps: Optional[Tuple[Tuple[int, ...], ...]] = None
    ang_tier_rows: Optional[Tuple[Tuple[int, ...], ...]] = None
    ang_cell_caps: Optional[Tuple[int, ...]] = None
    ang_cell_grid: Optional[Tuple[int, int, int]] = None
    cluster_plan: Optional[object] = None

    def __post_init__(self):
        if not (len(self.present) == len(self.rad_caps) == len(self.ang_caps)):
            raise ValueError('present/rad_caps/ang_caps must align')
        if self.cell_caps is not None and len(self.cell_caps) != len(self.present):
            raise ValueError('cell_caps must align with present')

    @property
    def rad_total(self) -> int:
        return int(sum(self.rad_caps))

    @property
    def ang_total(self) -> int:
        return int(sum(self.ang_caps))

    @property
    def rad_offsets(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in np.cumsum((0,) + self.rad_caps)[:-1])

    @property
    def ang_offsets(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in np.cumsum((0,) + self.ang_caps)[:-1])


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plan_blocked_layout(positions, box, species, radial_cutoff: float,
                        angular_cutoff: float, num_species: int,
                        margin: float = 1.2,
                        lane_multiple: int = 1) -> BlockedLayout:
    """Size a BlockedLayout from true per-species neighbor counts (host-side,
    one-time): exact max counts for this configuration, scaled by
    ``margin``, plus one, rounded up to ``lane_multiple``."""
    species = _host(species)
    present = tuple(int(s) for s in np.unique(species))
    counts_r, counts_a = per_species_neighbor_counts(
        positions, box, species, present, radial_cutoff, angular_cutoff)

    def size(c):
        c = int(np.ceil(c * margin)) + 1
        return int(-(-c // lane_multiple) * lane_multiple)

    return BlockedLayout(num_species=num_species, present=present,
                         rad_caps=tuple(size(c) for c in counts_r),
                         ang_caps=tuple(size(c) for c in counts_a))


def per_species_neighbor_counts(positions, box, species, present,
                                radial_cutoff: float, angular_cutoff: float,
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """True max per-species neighbor counts (radial and angular windows):
    a cell-binned O(N) host pass in numpy."""
    positions = _host(positions).astype(np.float64)
    species = _host(species)
    n = len(positions)
    rc = float(radial_cutoff)
    if box is not None:
        b = _host(box).astype(np.float64)
        widths = 1.0 / np.linalg.norm(np.linalg.inv(b), axis=0)
        nc = np.maximum((widths // rc).astype(int), 1)
        if (nc < 3).any():
            nc = np.array([1, 1, 1])
    else:
        b = None
        nc = np.array([1, 1, 1])
    ncell = int(np.prod(nc))
    if ncell == 1:
        cells = {0: np.arange(n)}
        stencil = {0: [0]}
    else:
        inv = np.linalg.inv(b)
        frac = positions @ inv
        frac -= np.floor(frac)
        c3 = np.minimum((frac * nc).astype(int), nc - 1)
        cell_of = (c3[:, 0] * nc[1] + c3[:, 1]) * nc[2] + c3[:, 2]
        cells = {}
        order = np.argsort(cell_of, kind='stable')
        bounds = np.searchsorted(cell_of[order], np.arange(ncell + 1))
        for c in range(ncell):
            cells[c] = order[bounds[c]:bounds[c + 1]]
        stencil = {}
        for c in range(ncell):
            cz = c % nc[2]
            cy = (c // nc[2]) % nc[1]
            cx = c // (nc[1] * nc[2])
            ids = set()
            for ox in (-1, 0, 1):
                for oy in (-1, 0, 1):
                    for oz in (-1, 0, 1):
                        ids.add((((cx + ox) % nc[0]) * nc[1]
                                 + (cy + oy) % nc[1]) * nc[2]
                                + (cz + oz) % nc[2])
            stencil[c] = sorted(ids)
    sp_index = {s: i for i, s in enumerate(present)}
    counts_r = np.zeros(len(present), np.int64)
    counts_a = np.zeros(len(present), np.int64)
    ra2 = float(angular_cutoff) ** 2
    rc2 = rc * rc
    for c, atoms in cells.items():
        if len(atoms) == 0:
            continue
        cand = np.concatenate([cells[q] for q in stencil[c]])
        delta = positions[cand][None, :, :] - positions[atoms][:, None, :]
        if b is not None:
            delta = delta - np.round(delta[..., 2:3] / b[2, 2]) * b[2]
            delta = delta - np.round(delta[..., 1:2] / b[1, 1]) * b[1]
            delta = delta - np.round(delta[..., 0:1] / b[0, 0]) * b[0]
        d2 = (delta ** 2).sum(-1)
        d2[atoms[:, None] == cand[None, :]] = np.inf
        sp_cand = species[cand]
        for s in present:
            m = sp_cand == s
            i = sp_index[s]
            counts_r[i] = max(counts_r[i], int((d2[:, m] < rc2).sum(1).max()))
            counts_a[i] = max(counts_a[i], int((d2[:, m] < ra2).sum(1).max()))
    return counts_r, counts_a


class BlockedSelection(NamedTuple):
    """A frozen species-blocked neighbor selection (cell-slot space).

    Reusable across MD steps while no atom has moved more than half the skin
    (build the CellList with cutoff + skin). Index tensors are int64.
    """
    order: Tensor           # [N] cell-sorted atom order at freeze time
    slot_of_sorted: Tensor  # [N] slot id per sorted atom (cc+1 = dropped)
    inv_order: Tensor       # [N] sorted position of each original atom
    slot_to_atom: Tensor    # [cc+1] original atom id per slot (N = empty)
    nbr_rad: Tensor         # [N, rad_total] neighbor slot ids (cc = pad)
    rad_mask: Tensor        # [N, rad_total] bool
    nbr_ang: Tensor         # [N, ang_total]
    ang_mask: Tensor        # [N, ang_total] bool
    max_rad: Tensor         # [n_present] true per-species radial counts
    max_ang: Tensor         # [n_present] true per-species angular counts
    max_cell_occupancy: Tensor
    # Lane position of angular neighbor l inside atom a's radial lane list
    # (rad_total = invalid): the angular list is a subsequence of the radial
    # list whenever no capacity overflowed.
    ang_in_rad: Tensor      # [N, ang_total]

    def did_overflow(self, layout: BlockedLayout, cell_capacity: int) -> Tensor:
        dev = self.max_rad.device
        rad_over = torch.any(self.max_rad > torch.tensor(layout.rad_caps, device=dev))
        ang_over = torch.any(self.max_ang > torch.tensor(layout.ang_caps, device=dev))
        return rad_over | ang_over | (self.max_cell_occupancy > cell_capacity)


class BlockedPayload(NamedTuple):
    """Per-step differentiable payload for the blocked lists, rows in the
    requested row order; padding lanes hold exact zeros. Deltas are
    coordinate planes ``[3, N, K]`` (the JAX layout, kept so the kernels
    and the tests read the same arrays)."""
    rad_deltas: Tensor      # [3, N, rad_total]
    rad_r: Tensor           # [N, rad_total]
    rad_mask: Tensor        # [N, rad_total]
    ang_deltas: Optional[Tensor]    # [3, N, ang_total]; None in rad-only mode
    ang_r: Optional[Tensor]         # [N, ang_total]
    ang_mask: Tensor        # [N, ang_total]
    max_rad: Tensor
    max_ang: Tensor
    max_cell_occupancy: Tensor
    ang_in_rad: Optional[Tensor] = None   # rad-only mode


def _scatter_rows(size: int, index: Tensor, values: Tensor,
                  fill) -> Tensor:
    """``full(size, fill).at[index].set(values, mode='drop')`` for indices
    in ``[0, size]``: the one extra row takes the dropped writes."""
    out = torch.full((size + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out = out.index_copy(0, index, values)
    return out[:size]


@torch.no_grad()
def select_blocked(cell_list: CellList, positions: Tensor, box: Tensor,
                   species, layout: BlockedLayout,
                   radial_cutoff: float, angular_cutoff: float,
                   ) -> BlockedSelection:
    """Freeze a species-blocked neighbor selection.

    The cell list's cutoff may exceed ``radial_cutoff`` by a Verlet skin; the
    angular window is widened by the same skin so both lists stay valid
    until any atom moves half the skin.
    """
    positions = positions.detach()
    box = box.detach()
    dev = positions.device
    n = positions.shape[0]
    if not cell_list.use_cells:
        return _select_blocked_dense(cell_list, positions, box, species,
                                     layout, radial_cutoff, angular_cutoff)
    nx, ny, nz = cell_list.ncells
    ncells = cell_list.num_cells
    ncells_arr = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    inv = torch.linalg.inv(box)
    frac = box_transform(positions, inv)
    frac = frac - torch.floor(frac)
    cell3 = torch.clamp((frac * ncells_arr).to(torch.int32),
                        torch.zeros_like(ncells_arr), ncells_arr - 1)
    cell_id = ((cell3[:, 0] * ny + cell3[:, 1]) * nz + cell3[:, 2]).long()

    order = torch.argsort(cell_id, stable=True)
    sorted_ids = cell_id[order]
    idx_n = torch.arange(n, device=dev)
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         sorted_ids[1:] != sorted_ids[:-1]])
    seg_start = torch.cummax(torch.where(new_seg, idx_n, 0), 0).values
    rank_sorted = idx_n - seg_start
    occupancy = torch.bincount(cell_id, minlength=ncells)
    max_occ = torch.max(occupancy)

    c = cell_list.cell_capacity
    cc = ncells * c
    slot_of_sorted = torch.where(rank_sorted < c,
                                 sorted_ids * c + rank_sorted, cc + 1)
    pos_sorted = positions[order]
    pos_slots = _scatter_rows(cc + 1, slot_of_sorted, pos_sorted, 0.0)[:cc]
    present_slots = _scatter_rows(
        cc + 1, slot_of_sorted, torch.ones(n, dtype=torch.bool, device=dev),
        False)[:cc]
    sp_sorted = torch.as_tensor(np.asarray(species), device=dev).long()[order]
    sp_slots = _scatter_rows(cc + 1, slot_of_sorted, sp_sorted,
                             layout.num_species)[:cc]

    stencil = torch.as_tensor(cell_list._stencil(), device=dev)   # [cells, 27]
    kk = 27 * c
    cand_slot = (stencil[:, :, None] * c
                 + torch.arange(c, device=dev)).reshape(ncells, kk)
    # Coarse block gathers (cell neighborhoods), then one row gather per atom.
    cand_pos_cells = pos_slots.reshape(ncells, c, 3)[stencil]
    cand_pos_cells = cand_pos_cells.reshape(ncells, kk, 3).permute(0, 2, 1)
    present_cells = present_slots.reshape(ncells, c)[stencil].reshape(ncells, kk)
    sp_cells = sp_slots.reshape(ncells, c)[stencil].reshape(ncells, kk)

    cand_pos = cand_pos_cells[sorted_ids]                  # [N, 3, kk]
    cand_present = present_cells[sorted_ids]               # [N, kk]
    cand_sp = sp_cells[sorted_ids]                         # [N, kk]
    cand_slot_atom = cand_slot[sorted_ids]                 # [N, kk]

    delta = cand_pos - pos_sorted[:, :, None]
    dx, dy, dz = delta[:, 0, :], delta[:, 1, :], delta[:, 2, :]
    dx, dy, dz = _wrap_planes(dx, dy, dz, box)
    d2 = dx * dx + dy * dy + dz * dz
    not_self = cand_slot_atom != slot_of_sorted[:, None]
    skin = cell_list.cutoff - radial_cutoff
    valid = cand_present & (d2 < cell_list.cutoff ** 2) & not_self
    ang_window = angular_cutoff + max(skin, 0.0)
    valid_ang = cand_present & (d2 < ang_window * ang_window) & not_self

    return _compact_blocked(n, cc, layout, valid, valid_ang, cand_sp,
                            cand_slot_atom, order, slot_of_sorted, idx_n,
                            max_occ)


def _wrap_planes(dx, dy, dz, box):
    """Plane-wise minimum image (the c, b, a row reduction of
    :func:`minimum_image` on coordinate planes)."""
    s3 = torch.round(dz / box[2, 2])
    dx = dx - s3 * box[2, 0]
    dy = dy - s3 * box[2, 1]
    dz = dz - s3 * box[2, 2]
    s2 = torch.round(dy / box[1, 1])
    dx = dx - s2 * box[1, 0]
    dy = dy - s2 * box[1, 1]
    dx = dx - torch.round(dx / box[0, 0]) * box[0, 0]
    return dx, dy, dz


def _compact_blocked(n, cc, layout, valid, valid_ang, cand_sp,
                     cand_slot_atom, order, slot_of_sorted, idx_n, max_occ):
    """Shared per-species packed-key compaction (cell and dense paths).

    Two-stage: one wide packed sort compacts all valid candidates (slot id
    major; species index and the angular-window bit in the low bits) to a
    narrow ``K1 = rad_total`` front block, then one sort per species with an
    angular-first key fills that species' static lanes. A row can lose a
    valid candidate to the K1 truncation only if some species is over its
    cap, which the full-width counts below report.
    """
    dev = valid.device
    npres = len(layout.present)
    sp_table = np.full(layout.num_species + 1, npres, np.int64)
    for i, s in enumerate(layout.present):
        sp_table[s] = i
    sp_idx = torch.as_tensor(sp_table, device=dev)[cand_sp]        # [N, kk]

    max_rad, max_ang = [], []
    for i in range(npres):
        is_s = sp_idx == i
        max_rad.append(torch.max(torch.sum(valid & is_s, 1)))
        max_ang.append(torch.max(torch.sum(valid_ang & is_s, 1)))

    kk = cand_slot_atom.shape[1]
    stride = 2 * (npres + 1)
    k1 = min(kk, -(-layout.rad_total // 8) * 8)
    if cc * stride + stride < _SENTINEL and k1 < kk:
        # int32 keys, as in JAX: the guard above keeps them below the
        # sentinel.
        packed = (cand_slot_atom * stride + sp_idx * 2
                  + valid_ang.long()).to(torch.int32)
        packed = torch.where(valid, packed, _SENTINEL)
        stage1 = torch.sort(packed, dim=1).values[:, :k1].long()  # [N, K1]
        valid1 = stage1 < _SENTINEL
        safe1 = torch.where(valid1, stage1, 0)
        slot1 = safe1 // stride
        rem = safe1 % stride
        sp1 = rem // 2
        ang1 = (rem % 2) == 1
    else:                       # tiny candidate sets / giant slot spaces
        slot1 = cand_slot_atom
        sp1 = sp_idx
        ang1 = valid_ang
        valid1 = valid
    # Angular-first key per species: [ang-window neighbors (slot asc) |
    # other radial neighbors (slot asc) | padding].
    base2 = cc + 2
    nbr_rad, rad_masks, nbr_ang, ang_masks, air = [], [], [], [], []
    krt = layout.rad_total
    for i in range(npres):
        is_s = valid1 & (sp1 == i)
        key = torch.where(is_s, slot1 + torch.where(ang1, 0, base2),
                          2 * base2 + cc)
        key = torch.sort(key, dim=1).values[:, :layout.rad_caps[i]]
        is_ang = key < base2
        slot_s = torch.where(is_ang, key, key - base2)
        m = key < 2 * base2
        nbr_rad.append(torch.where(m, slot_s, cc))
        rad_masks.append(m)
        ac = layout.ang_caps[i]
        ro = layout.rad_offsets[i]
        nbr_ang.append(torch.where(is_ang[:, :ac], slot_s[:, :ac], cc))
        ang_masks.append(is_ang[:, :ac])
        lanes = torch.arange(ro, ro + ac, device=dev)[None]
        air.append(torch.where(is_ang[:, :ac], lanes, krt))

    inv_order = torch.zeros(n, dtype=torch.long, device=dev)
    inv_order[order] = idx_n
    slot_to_atom = _scatter_rows(cc + 1, slot_of_sorted, order, n)
    return BlockedSelection(
        order=order, slot_of_sorted=slot_of_sorted,
        inv_order=inv_order, slot_to_atom=slot_to_atom,
        nbr_rad=torch.cat(nbr_rad, 1), rad_mask=torch.cat(rad_masks, 1),
        nbr_ang=torch.cat(nbr_ang, 1), ang_mask=torch.cat(ang_masks, 1),
        max_rad=torch.stack(max_rad), max_ang=torch.stack(max_ang),
        max_cell_occupancy=max_occ,
        ang_in_rad=torch.cat(air, 1))


def _select_blocked_dense(cell_list: CellList, positions, box, species,
                          layout, radial_cutoff, angular_cutoff):
    """Degenerate single-cell path (small or nonperiodic systems): every atom
    is a candidate of every other; slots are atom ids (cc = n)."""
    dev = positions.device
    n = positions.shape[0]
    delta = positions[None, :, :] - positions[:, None, :]
    delta = minimum_image(delta, box)
    d2 = torch.sum(delta * delta, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    skin = cell_list.cutoff - radial_cutoff
    valid = (d2 < cell_list.cutoff ** 2) & ~eye
    ang_window = angular_cutoff + max(skin, 0.0)
    valid_ang = (d2 < ang_window * ang_window) & ~eye
    sp = torch.as_tensor(np.asarray(species), device=dev).long()
    cand_sp = sp[None, :].expand(n, n)
    idx_n = torch.arange(n, device=dev)
    cand_slot_atom = idx_n[None, :].expand(n, n)
    return _compact_blocked(n, n, layout, valid, valid_ang, cand_sp,
                            cand_slot_atom, idx_n, idx_n, idx_n,
                            torch.tensor(n, device=dev))


def payload_from_blocked(cell_list: CellList, positions: Tensor, box: Tensor,
                         sel: BlockedSelection,
                         rad_only: bool = False,
                         layout: Optional[BlockedLayout] = None,
                         row_order: Optional[Tensor] = None,
                         num_slots: Optional[int] = None,
                         ) -> BlockedPayload:
    """The differentiable per-step phase: scatter current positions into the
    frozen slots, gather the radial lanes' neighbor positions (one gather,
    whose autograd adjoint is an ``index_add``), and recompute the
    minimum-image deltas and distances as coordinate planes.

    ``rad_only``: skip the angular slices (``ang_deltas``/``ang_r`` = None);
    the angular kernel slices the radial planes itself.
    ``layout``: required unless ``rad_only`` (slice boundaries).
    ``row_order``: internal (cell-sorted) row index per output row; defaults
    to ``sel.inv_order`` (original atom order). A species-grouped order
    makes every payload row, and so every AEV row, come out grouped.
    ``num_slots``: the selection's slot count when it was made on another
    grid than ``cell_list``'s (the window path's angular grid).
    """
    n = positions.shape[0]
    pos_sorted = positions.index_select(0, sel.order)
    if cell_list.use_cells or num_slots is not None:
        cc = (num_slots if num_slots is not None
              else cell_list.num_cells * cell_list.cell_capacity)
        slots = torch.zeros(cc + 2, 3, dtype=positions.dtype,
                            device=positions.device)
        slots = slots.index_copy(0, sel.slot_of_sorted, pos_sorted)[:cc + 1]
    else:
        slots = torch.cat([pos_sorted, pos_sorted.new_zeros(1, 3)], 0)
    idx = sel.nbr_rad
    gathered = slots.index_select(0, idx.reshape(-1)).reshape(
        n, idx.shape[1], 3).permute(2, 0, 1)

    dx = gathered[0] - pos_sorted[:, 0:1]
    dy = gathered[1] - pos_sorted[:, 1:2]
    dz = gathered[2] - pos_sorted[:, 2:3]
    if box is not None:
        dx, dy, dz = _wrap_planes(dx, dy, dz, box)
    mask = sel.rad_mask
    deltas = torch.where(mask[None], torch.stack([dx, dy, dz]), 0.0)
    r = torch.sqrt(torch.where(mask, dx * dx + dy * dy + dz * dz, 1.0))
    r = torch.where(mask, r, 0.0)

    io = sel.inv_order if row_order is None else row_order
    rad_deltas, rad_r = deltas.index_select(1, io), r.index_select(0, io)
    ang_mask = sel.ang_mask[io]
    if rad_only:
        ang_deltas = ang_r = None
        ang_in_rad = sel.ang_in_rad[io]
    else:
        if layout is None:
            raise ValueError('layout required unless rad_only=True')
        spans = list(zip(layout.rad_offsets, layout.ang_caps))
        ang_deltas = torch.cat([rad_deltas[:, :, ro:ro + ac]
                                for ro, ac in spans], 2)
        ang_r = torch.cat([rad_r[:, ro:ro + ac] for ro, ac in spans], 1)
        ang_deltas = torch.where(ang_mask[None], ang_deltas, 0.0)
        ang_r = torch.where(ang_mask, ang_r, 0.0)
        ang_in_rad = None
    return BlockedPayload(
        rad_deltas=rad_deltas, rad_r=rad_r, rad_mask=mask[io],
        ang_deltas=ang_deltas, ang_r=ang_r, ang_mask=ang_mask,
        max_rad=sel.max_rad, max_ang=sel.max_ang,
        max_cell_occupancy=sel.max_cell_occupancy,
        ang_in_rad=ang_in_rad)


def build_blocked_payload(cell_list: CellList, positions: Tensor, box: Tensor,
                          species, layout: BlockedLayout,
                          radial_cutoff: float, angular_cutoff: float,
                          ) -> BlockedPayload:
    """Select and payload in one call (non-sticky stepping)."""
    sel = select_blocked(cell_list, positions, box, species, layout,
                         radial_cutoff, angular_cutoff)
    return payload_from_blocked(cell_list, positions, box, sel, layout=layout)
