"""O(N) cell-list neighbor selection with static shapes (port of
``nnpops_tpu.neighbors.cell_list``).

The cell grid is sized from the box's perpendicular widths (rectangular
and reduced triclinic boxes share one code path in fractional space), so a
27-cell stencil always covers the cutoff. Capacities are static (cells x C
slots, atoms x 27C candidates, atoms x K neighbors); overflow is reported
as data (``max_neighbors``, ``max_cell_occupancy``), never as a shape
change: the soft-failure contract of ``getNeighborPairs``.

``build`` gives a directed index list (``NeighborList``); ``select`` then
``payload_from_selection`` (``build_payload``) a list that carries each
neighbor's delta, distance and features, with ``select`` frozen across
Verlet-skin steps. On a degenerate one-cell grid ``build`` and
``build_payload`` take all pairs (``_build_dense``, ``_payload_dense``).

Like the JAX package, ``select`` has no one-cell guard: on a grid under 3
cells wide (one cell) all 27 stencil entries name cell 0, every candidate
is counted 27 times and ``max_neighbors`` reports it as overflow.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import box_transform, minimum_image, validate_box
from ..ops.compaction import compact_rows
from .pairs import MaskedPairs

Tensor = torch.Tensor


def _as_numpy_box(box) -> np.ndarray:
    if isinstance(box, torch.Tensor):
        box = box.detach().cpu().numpy()
    return np.asarray(box, dtype=np.float64)


def _perpendicular_widths(box) -> np.ndarray:
    """Distance between opposite faces of the unit cell along each fractional
    axis: 1 / ||column i of the inverse box|| (row norms would overestimate
    tilted widths and let the 27-cell stencil miss neighbors)."""
    inv = np.linalg.inv(_as_numpy_box(box))
    return 1.0 / np.linalg.norm(inv, axis=0)


def _drop_scatter(size: int, index: Tensor, values: Tensor, fill) -> Tensor:
    """``full(size, fill).at[index].set(values, mode='drop')`` for indices in
    ``[0, size + 1]`` (sentinel rows take the dropped writes); differentiable
    in ``values``."""
    out = torch.full((size + 2,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    return out.index_copy(0, index.long(), values)[:size]


class NeighborPayload(NamedTuple):
    """A neighbor list that carries its data (``CellList.build_payload``), in
    original atom order, padded to capacity K with mask=False entries that
    hold exact zeros (grad-safe)."""
    deltas: Tensor               # [N, K, 3] atom -> neighbor (min-imaged)
    distances: Tensor            # [N, K]
    features: Optional[Tensor]   # [N, K, F] per-neighbor features, or None
    indices: Tensor              # [N, K] int32 neighbor atom ids (N = pad)
    mask: Tensor                 # [N, K] bool
    max_neighbors: Tensor        # [] int32 true count (> K: overflow)
    max_cell_occupancy: Tensor   # [] int32

    def did_overflow(self, capacity: int, cell_capacity: int) -> Tensor:
        return ((self.max_neighbors > capacity)
                | (self.max_cell_occupancy > cell_capacity))


class NeighborList(NamedTuple):
    """A per-atom directed neighbor list (``CellList.build``).

    ``max_neighbors`` is the true largest neighbor count: above K some
    neighbors were dropped. ``max_cell_occupancy`` is the true largest cell
    occupancy: above the cell capacity the candidates were truncated. Read
    both on the host between segments, never inside a step."""
    indices: Tensor              # [N, K] int32, padded with the sentinel N
    max_neighbors: Tensor        # [] int32
    max_cell_occupancy: Tensor   # [] int32

    def did_overflow(self, capacity: int, cell_capacity: int) -> Tensor:
        return ((self.max_neighbors > capacity)
                | (self.max_cell_occupancy > cell_capacity))


class SlotSelection(NamedTuple):
    """A frozen neighbor selection in cell-slot space (``CellList.select``),
    int32 throughout as in the JAX package. Reusable while no atom has moved
    more than half the skin (build the CellList with ``cutoff + skin``)."""
    order: Tensor            # [N] sorted-by-cell atom order at freeze time
    slot_of_sorted: Tensor   # [N] slot id per sorted atom (cc+1 = dropped)
    inv_order: Tensor        # [N] sorted position of each original atom
    slot_to_atom: Tensor     # [cc+1] original atom id per slot (N = empty)
    nbr_slot_k: Tensor       # [N, K] compacted neighbor slot ids (cc = pad)
    mask: Tensor             # [N, K] bool valid-pair mask at freeze time
    max_neighbors: Tensor
    max_cell_occupancy: Tensor
    # [N, K] flat index of each directed entry's reverse copy (N*K =
    # invalid), from select(build_mirror=True); the distance payload's
    # scatter-free position adjoint consumes it.
    mirror: Optional[Tensor] = None


class _DistPayload(torch.autograd.Function):
    """Distances from a frozen selection in sorted-atom row space, with the
    mirror-routed position adjoint of the JAX package's
    ``_make_dist_payload``: deterministic, no atomics, no box cotangent."""

    @staticmethod
    def forward(ctx, p, box, sel, cc):
        n, k = sel.nbr_slot_k.shape
        pos_sorted = p.index_select(0, sel.order)
        slots = _drop_scatter(cc + 1, sel.slot_of_sorted, pos_sorted, 0.0)
        nbr = slots.index_select(0, sel.nbr_slot_k.reshape(-1)).reshape(n, k, 3)
        deltas = minimum_image(nbr - pos_sorted[:, None, :], box)
        d = torch.sqrt(torch.where(sel.mask, torch.sum(deltas * deltas, -1),
                                   1.0))
        d = torch.where(sel.mask, d, 0.0)
        ctx.save_for_backward(d, deltas, sel.mask, sel.mirror, sel.inv_order)
        return d

    @staticmethod
    def backward(ctx, g):
        d, deltas, mask, mirror, inv_order = ctx.saved_tensors
        n, k = d.shape
        tot = n * k
        live = mask & (d > 0.0)
        u = deltas / torch.where(live, d, 1.0)[..., None]
        dcot = torch.where(live, g, 0.0)
        # d_pos_i = -sum_l (D[i,l] + D[mirror(i,l)]) u[i,l]: the mirror is an
        # involution on the valid entries (identity elsewhere), so applying
        # it is one gather.
        flat = torch.arange(tot, device=d.device)
        mflat = mirror.reshape(-1).long()
        key = torch.where(mask.reshape(-1) & (mflat < tot), mflat, flat)
        dm = torch.where(live, dcot.reshape(-1).index_select(0, key)
                         .reshape(n, k), 0.0)
        rows = -torch.sum((dcot + dm)[..., None] * u, 1)       # [N, 3]
        return rows.index_select(0, inv_order), None, None, None


class _DeltaPayload(torch.autograd.Function):
    """Deltas (atom -> neighbor, minimum-imaged) from a frozen selection in
    sorted-atom row space, exact zeros on masked lanes, with the
    mirror-routed position adjoint: an entry's pos_j half is its mirrored
    entry's pos_i half, so ``d_pos_i = sum_l (G[mirror(i, l)] - G[i, l])``
    over row i's valid lanes (G the deltas' cotangent). Deterministic, no
    atomics, no box cotangent."""

    @staticmethod
    def forward(ctx, p, box, sel, cc):
        n, k = sel.nbr_slot_k.shape
        pos_sorted = p.index_select(0, sel.order)
        slots = _drop_scatter(cc + 1, sel.slot_of_sorted, pos_sorted, 0.0)
        nbr = slots.index_select(0, sel.nbr_slot_k.reshape(-1)).reshape(n, k, 3)
        deltas = minimum_image(nbr - pos_sorted[:, None, :], box)
        ctx.save_for_backward(sel.mask, sel.mirror, sel.inv_order)
        return torch.where(sel.mask[..., None], deltas, 0.0)

    @staticmethod
    def backward(ctx, g):
        mask, mirror, inv_order = ctx.saved_tensors
        n, k = mask.shape
        tot = n * k
        g = torch.where(mask[..., None], g, 0.0).reshape(tot, 3)
        # A valid entry whose reverse is missing (a row cut by overflow,
        # which the counts report) loses its pos_j half.
        mflat = mirror.reshape(-1).long()
        has = mask.reshape(-1) & (mflat < tot)
        gm = torch.where(has[:, None],
                         g.index_select(0, torch.where(has, mflat, 0)), 0.0)
        rows = torch.sum((gm - g).reshape(n, k, 3), 1)         # [N, 3]
        return rows.index_select(0, inv_order), None, None, None


@dataclasses.dataclass(frozen=True)
class CellList:
    """A static cell decomposition bound to one box geometry (host-built)."""
    cutoff: float
    ncells: Tuple[int, int, int]
    capacity: int            # max neighbors per atom (K)
    cell_capacity: int       # max atoms per cell (C)

    @classmethod
    def create(cls, box, cutoff: float, capacity: int,
               cell_capacity: Optional[int] = None,
               density_estimate: float = 0.1,
               validate: bool = True) -> 'CellList':
        """Size the decomposition for a box; a box under 3 cells wide along
        an axis degenerates to one cell (all pairs), where the 27-stencil
        would alias. Same sizing rule as the JAX class."""
        if validate:
            validate_box(box, cutoff)
        widths = _perpendicular_widths(box)
        ncells = np.maximum(np.floor(widths / cutoff).astype(int), 1)
        if (ncells < 3).any():
            ncells = np.array([1, 1, 1])
        if cell_capacity is None:
            volume = abs(np.linalg.det(_as_numpy_box(box)))
            cell_volume = volume / int(np.prod(ncells))
            # Mean occupancy + ~4.5 sigma Poisson headroom, rounded up to a
            # multiple of 8; overflow stays reported (max_cell_occupancy).
            mean_occ = density_estimate * cell_volume
            cell_capacity = max(8, int(np.ceil(mean_occ + 4.5 * np.sqrt(mean_occ) + 2)))
            cell_capacity = -(-cell_capacity // 8) * 8
        return cls(cutoff=float(cutoff), ncells=tuple(int(x) for x in ncells),
                   capacity=int(capacity), cell_capacity=int(cell_capacity))

    @classmethod
    def for_density(cls, box, num_atoms: int, radius: float) -> 'CellList':
        """The cell list of ``num_atoms`` atoms in ``box`` at ``radius``
        (a cutoff plus its Verlet skin): K = the neighbors a sphere of that
        radius holds at the box's density plus 30 %, rounded up to 128 (the
        rule of the JAX package's ``bench_cfconv_periodic``); cells sized
        at that density."""
        box_np = _as_numpy_box(box)
        density = num_atoms / abs(np.linalg.det(box_np))
        capacity = int(4 / 3 * np.pi * radius ** 3 * density * 1.3)
        capacity = max(1, -(-capacity // 128)) * 128
        return cls.create(box_np, radius, capacity=capacity,
                          density_estimate=density)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.ncells))

    @property
    def use_cells(self) -> bool:
        return self.num_cells >= 27

    def _stencil(self) -> np.ndarray:
        """Flat cell ids of the 27-neighborhood for every cell, [cells, 27]."""
        nx, ny, nz = self.ncells
        cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                 indexing='ij')
        offs = np.array(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                    indexing='ij')).reshape(3, 27).T
        ids = []
        for ox, oy, oz in offs:
            ids.append((((cx + ox) % nx) * ny + (cy + oy) % ny) * nz + (cz + oz) % nz)
        return np.stack(ids, axis=-1).reshape(self.num_cells, 27)

    def _stencil_slots(self, device) -> Tuple[Tensor, Tensor]:
        """([cells, 27] stencil, [cells, 27C] candidate slot ids) on
        ``device``, uploaded once per cell list and device (a copy inside
        the MD loop would synchronise it)."""
        return _stencil_tables(self, torch.device(device))

    def cell_ids(self, positions: Tensor, box: Tensor) -> Tensor:
        """[N] int64 cell id of every atom, in the JAX package's order of
        operations (LU inverse of the box, f32 wrap, truncation)."""
        from ..ops.aev_blocked import device_constant   # (import cycle)
        nx, ny, nz = self.ncells
        grid = device_constant((nx, ny, nz), torch.int32, positions.device)
        frac = box_transform(positions, torch.linalg.inv_ex(box).inverse)
        frac = frac - torch.floor(frac)
        cell3 = torch.clamp((frac * grid).to(torch.int32),
                            torch.zeros_like(grid), grid - 1).long()
        return (cell3[:, 0] * ny + cell3[:, 1]) * nz + cell3[:, 2]

    @torch.no_grad()
    def build(self, positions: Tensor, box: Tensor) -> NeighborList:
        """The directed neighbor list: each atom's neighbors inside the
        cutoff, in candidate order (the 27 stencil cells' slots), compacted
        to K. Every integer output equals the JAX package's."""
        n = positions.shape[0]
        if not self.use_cells:
            return self._build_dense(positions, box)
        dev = positions.device
        c = self.cell_capacity
        cc = self.num_cells * c
        cell_id = self.cell_ids(positions, box)
        # Rank of each atom within its cell: one stable sort.
        order = torch.argsort(cell_id, stable=True)
        sorted_ids = cell_id[order]
        first = torch.searchsorted(sorted_ids, sorted_ids, side='left')
        rank = torch.empty_like(order).index_copy_(
            0, order, torch.arange(n, device=dev) - first)
        occupancy = torch.zeros(self.num_cells, dtype=torch.int32,
                                device=dev).index_add_(
            0, cell_id, torch.ones(n, dtype=torch.int32, device=dev))
        # Atoms into [cells * C] slots; ranks past the capacity drop.
        slot_idx = torch.where(rank < c, cell_id * c + rank, cc)
        slots = _drop_scatter(cc, slot_idx, torch.arange(n, device=dev), n)
        stencil, cand_slot = self._stencil_slots(dev)
        cand = slots.index_select(0, cand_slot.index_select(
            0, cell_id).reshape(-1).long()).reshape(n, 27 * c)
        in_range = cand < n
        safe = torch.where(in_range, cand, 0)
        delta = positions.index_select(0, safe.reshape(-1)).reshape(
            n, 27 * c, 3) - positions[:, None, :]
        delta = minimum_image(delta, box)
        d2 = torch.sum(delta * delta, -1)
        valid = (in_range & (d2 < self.cutoff * self.cutoff)
                 & (cand != torch.arange(n, device=dev)[:, None]))
        counts = torch.sum(valid, 1, dtype=torch.int32)
        take, kept_valid = compact_rows(valid, self.capacity)
        kept = torch.where(kept_valid, torch.gather(cand, 1, take.long()), n)
        return NeighborList(kept.to(torch.int32), torch.max(counts),
                            torch.max(occupancy))

    def build_payload(self, positions: Tensor, box: Tensor,
                      features: Optional[Tensor] = None) -> NeighborPayload:
        """A neighbor list that CARRIES its data (deltas, distances and
        per-neighbor ``features`` [N, F]), differentiable in positions and
        features: :meth:`select`, then :meth:`payload_from_selection`; the
        dense path on a one-cell grid. On capacity overflow (reported via
        the counts) the result is incomplete."""
        if not self.use_cells:
            return self._payload_dense(positions, box, features)
        sel = self.select(positions, box)
        return self.payload_from_selection(positions, box, sel, features)

    def select(self, positions: Tensor, box: Tensor,
               build_mirror: bool = False) -> SlotSelection:
        """The non-differentiable selection phase: cell assignment, slot
        packing and per-atom compaction to K, over the N real atoms sorted
        by cell. Every integer field equals the JAX package's.
        ``build_mirror`` also pairs every directed entry with its reverse
        copy (``window._mirror_packed``), which the scatter-free distance
        payload needs."""
        with torch.no_grad():
            positions, box = positions.detach(), box.detach()
            n = positions.shape[0]
            dev = positions.device
            c = self.cell_capacity
            cc = self.num_cells * c
            cell_id = self.cell_ids(positions, box)
            order = torch.argsort(cell_id, stable=True)
            sorted_ids = cell_id[order]
            # Rank within cell: index - cummax(segment start).
            idx_n = torch.arange(n, device=dev)
            new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                 sorted_ids[1:] != sorted_ids[:-1]])
            seg_start = torch.cummax(torch.where(new_seg, idx_n, 0), 0).values
            rank_sorted = idx_n - seg_start
            # index_add, not bincount: bincount on a CUDA tensor synchronises.
            occupancy = torch.zeros(self.num_cells, dtype=torch.int32,
                                    device=dev).index_add_(
                0, cell_id, torch.ones(n, dtype=torch.int32, device=dev))
            max_occ = torch.max(occupancy)
            # Cell-overflow atoms go to slot cc+1, dropped from every slot
            # array; they keep their own row, and only their absence from
            # the others' candidates is the (reported) error.
            slot_of_sorted = torch.where(rank_sorted < c,
                                         sorted_ids * c + rank_sorted, cc + 1)
            pos_sorted = positions.index_select(0, order)
            pos_slots = _drop_scatter(cc, slot_of_sorted, pos_sorted, 0.0)
            present = _drop_scatter(
                cc, slot_of_sorted,
                torch.ones(n, dtype=torch.bool, device=dev), False)

            stencil, cand_slot = self._stencil_slots(dev)
            kk = 27 * c
            cells = self.num_cells
            cand_pos_cells = pos_slots.reshape(cells, c, 3)[stencil].reshape(
                cells, kk, 3).transpose(1, 2)                  # [cells, 3, kk]
            present_cells = present.reshape(cells, c)[stencil].reshape(
                cells, kk)
            cand_pos = cand_pos_cells.index_select(0, sorted_ids)  # [N, 3, kk]
            cand_present = present_cells.index_select(0, sorted_ids)
            cand_slot_atom = cand_slot.index_select(0, sorted_ids)  # [N, kk]

            delta = cand_pos - pos_sorted[:, :, None]
            # Reduced-box minimum image, component form (c, then b, then a).
            dx, dy, dz = delta[:, 0, :], delta[:, 1, :], delta[:, 2, :]
            s3 = torch.round(dz / box[2, 2])
            dx = dx - s3 * box[2, 0]
            dy = dy - s3 * box[2, 1]
            dz = dz - s3 * box[2, 2]
            s2 = torch.round(dy / box[1, 1])
            dx = dx - s2 * box[1, 0]
            dy = dy - s2 * box[1, 1]
            dx = dx - torch.round(dx / box[0, 0]) * box[0, 0]
            d2 = dx * dx + dy * dy + dz * dz                   # [N, kk]
            del cand_pos, delta, dx, dy, dz
            valid = (cand_present & (d2 < self.cutoff * self.cutoff)
                     & (cand_slot_atom != slot_of_sorted[:, None]))
            counts = torch.sum(valid, 1, dtype=torch.int32)

            # Compaction needs no distance order: pack (validity | slot id)
            # into one int32 key, valid candidates first by slot id.
            packed = torch.where(valid, cand_slot_atom,
                                 cand_slot_atom + (cc + 1)).to(torch.int32)
            packed_k = torch.sort(packed, 1).values[:, :self.capacity]
            mask = packed_k <= cc
            nbr_slot_k = torch.where(mask, packed_k, cc)

            inv_order = torch.empty_like(order).index_copy_(0, order, idx_n)
            slot_to_atom = _drop_scatter(cc + 1, slot_of_sorted, order, n)
            slot32 = slot_of_sorted.to(torch.int32)
            mirror = None
            if build_mirror:
                from .window import _mirror_packed
                mirror = _mirror_packed([(slot32, nbr_slot_k, mask)], cc,
                                        grid3=self.ncells, c_per_cell=c)[0]
            return SlotSelection(
                order=order.to(torch.int32), slot_of_sorted=slot32,
                inv_order=inv_order.to(torch.int32),
                slot_to_atom=slot_to_atom.to(torch.int32),
                nbr_slot_k=nbr_slot_k, mask=mask,
                max_neighbors=torch.max(counts),
                max_cell_occupancy=max_occ, mirror=mirror)

    def payload_from_selection(self, positions: Tensor, box: Tensor,
                               sel: SlotSelection,
                               features: Optional[Tensor] = None,
                               ) -> NeighborPayload:
        """The differentiable payload phase: re-scatter current positions
        (+features) into the frozen slots, fetch each atom's compacted
        neighbors with one gather, recompute deltas/distances (autograd's
        adjoints: ``index_add`` for the gathers)."""
        n = positions.shape[0]
        cc = self.num_cells * self.cell_capacity
        k = sel.nbr_slot_k.shape[1]
        pos_sorted = positions.index_select(0, sel.order)
        parts = [pos_sorted]
        if features is not None:
            parts.append(features.index_select(0, sel.order))
        packed = torch.cat(parts, 1)                           # [N, W]
        width = packed.shape[1]
        slots = _drop_scatter(cc + 1, sel.slot_of_sorted, packed, 0.0)
        nbr_payload = slots.index_select(0, sel.nbr_slot_k.reshape(-1)).reshape(
            n, k, width)
        deltas = minimum_image(nbr_payload[..., :3] - pos_sorted[:, None, :],
                               box)
        deltas = torch.where(sel.mask[..., None], deltas, 0.0)
        dist = torch.sqrt(torch.where(sel.mask, torch.sum(deltas * deltas, -1),
                                      1.0))
        dist = torch.where(sel.mask, dist, 0.0)
        nbr_idx = torch.where(
            sel.mask, sel.slot_to_atom[sel.nbr_slot_k.long()], n)
        io = sel.inv_order
        feats = None
        if features is not None:
            feats = nbr_payload[..., 3:].index_select(0, io)
        return NeighborPayload(
            deltas=deltas.index_select(0, io),
            distances=dist.index_select(0, io), features=feats,
            indices=nbr_idx.index_select(0, io),
            mask=sel.mask.index_select(0, io),
            max_neighbors=sel.max_neighbors,
            max_cell_occupancy=sel.max_cell_occupancy)

    def payload_distances_from_selection(self, positions: Tensor, box: Tensor,
                                         sel: SlotSelection):
        """Distances-only payload phase with a SCATTER-FREE position adjoint
        (needs ``sel.mirror``: ``select(build_mirror=True)``).

        Returns ``(distances [N, K], indices [N, K] int32, mask [N, K])`` in
        ORIGINAL atom order. For consumers that differentiate only through
        the distances (CFConv), the position adjoint is
        ``d_pos_i = -sum_l (D[i,l] + D_mirror[i,l]) u[i,l]`` (D the distance
        cotangent, u the unit delta): each directed entry's pos_j half is
        its mirrored entry's pos_i half. Deterministic, no atomics, and like
        the JAX package no box cotangent."""
        if sel.mirror is None:
            raise ValueError('payload_distances_from_selection needs a '
                             'selection built with select(build_mirror='
                             'True)')
        from .window import _perm_gather
        n = positions.shape[0]
        cc = self.num_cells * self.cell_capacity
        dist_sorted = _DistPayload.apply(positions, box, sel, cc)
        dist = _perm_gather(dist_sorted, sel.inv_order, sel.order)
        nbr_idx = torch.where(sel.mask, sel.slot_to_atom[sel.nbr_slot_k.long()],
                              n)
        return (dist, nbr_idx.index_select(0, sel.inv_order),
                sel.mask.index_select(0, sel.inv_order))

    def payload_deltas_from_selection(self, positions: Tensor, box: Tensor,
                                      sel: SlotSelection):
        """Deltas payload phase with a SCATTER-FREE position adjoint (needs
        ``sel.mirror``: ``select(build_mirror=True)``), for consumers that
        need each lane's direction as well as its length (PaiNN).

        Returns ``(deltas [N, K, 3], indices [N, K] int32, mask [N, K])``
        in ORIGINAL atom order, deltas atom -> neighbor (minimum-imaged,
        exact zeros on masked lanes), the padded indices N. The adjoint is
        ``d_pos_i = sum_l (G[mirror(i, l)] - G[i, l])``: one gather, no
        ``index_add``, no atomics, and like the distances payload no box
        cotangent."""
        if sel.mirror is None:
            raise ValueError('payload_deltas_from_selection needs a '
                             'selection built with select(build_mirror='
                             'True)')
        from .window import _perm_gather
        n = positions.shape[0]
        cc = self.num_cells * self.cell_capacity
        deltas_sorted = _DeltaPayload.apply(positions, box, sel, cc)
        deltas = _perm_gather(deltas_sorted, sel.inv_order, sel.order)
        nbr_idx = torch.where(sel.mask, sel.slot_to_atom[sel.nbr_slot_k.long()],
                              n)
        return (deltas, nbr_idx.index_select(0, sel.inv_order),
                sel.mask.index_select(0, sel.inv_order))

    def _payload_dense(self, positions: Tensor, box: Optional[Tensor],
                       features: Optional[Tensor]) -> NeighborPayload:
        """Degenerate one-cell path: dense pairs, the same payload contract,
        neighbors in distance order."""
        n = positions.shape[0]
        dev = positions.device
        delta = minimum_image(positions[None, :, :] - positions[:, None, :],
                              box)
        d2 = torch.sum(delta * delta, -1)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        valid = (d2 < self.cutoff * self.cutoff) & ~eye
        counts = torch.sum(valid, 1, dtype=torch.int32)
        k = min(self.capacity, n)
        key = torch.where(valid, d2.detach(), float('inf'))
        key_s, nbr = torch.sort(key, dim=1, stable=True)
        mask = torch.isfinite(key_s[:, :k])
        nbr = torch.where(mask, nbr[:, :k], n)
        pos_pad = torch.cat([positions, positions.new_zeros(1, 3)])
        gathered = pos_pad.index_select(0, nbr.reshape(-1)).reshape(n, k, 3)
        deltas = minimum_image(gathered - positions[:, None, :], box)
        deltas = torch.where(mask[..., None], deltas, 0.0)
        dist = torch.sqrt(torch.where(mask, torch.sum(deltas * deltas, -1),
                                      1.0))
        dist = torch.where(mask, dist, 0.0)
        feats = None
        if features is not None:
            f_pad = torch.cat([features,
                               features.new_zeros(1, features.shape[1])])
            feats = torch.where(mask[..., None], f_pad.index_select(
                0, nbr.reshape(-1)).reshape(n, k, -1), 0.0)
        return NeighborPayload(
            deltas=deltas, distances=dist, features=feats,
            indices=nbr.to(torch.int32), mask=mask,
            max_neighbors=torch.max(counts),
            max_cell_occupancy=torch.tensor(n, dtype=torch.int32, device=dev))


    @torch.no_grad()
    def _build_dense(self, positions: Tensor,
                     box: Optional[Tensor]) -> NeighborList:
        """Degenerate one-cell path: all pairs as candidates, the same
        output contract (K capped at N)."""
        n = positions.shape[0]
        delta = minimum_image(positions[None, :, :] - positions[:, None, :],
                              box)
        d2 = torch.sum(delta * delta, -1)
        eye = torch.eye(n, dtype=torch.bool, device=positions.device)
        valid = (d2 < self.cutoff * self.cutoff) & ~eye
        counts = torch.sum(valid, 1, dtype=torch.int32)
        take, kept_valid = compact_rows(valid, min(self.capacity, n))
        return NeighborList(
            torch.where(kept_valid, take, n).to(torch.int32),
            torch.max(counts),
            torch.tensor(n, dtype=torch.int32, device=positions.device))


def lane_geometry(deltas: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """(d [N, K], u [N, K, 3]) of the deltas payload
    (``CellList.payload_deltas_from_selection``) by plain autograd: lengths
    and unit vectors, exact zeros (and zero gradients) on masked lanes."""
    d2 = torch.where(mask, torch.sum(deltas * deltas, -1), 1.0)
    d = torch.sqrt(d2)
    u = deltas / d[..., None]
    return torch.where(mask, d, 0.0), torch.where(mask[..., None], u, 0.0)


@functools.lru_cache(maxsize=16)
def _stencil_tables(cell_list: CellList, device: torch.device
                    ) -> Tuple[Tensor, Tensor]:
    from ..ops.aev_blocked import upload   # (import cycle)
    c = cell_list.cell_capacity
    stencil = cell_list._stencil()
    cand = (stencil[:, :, None] * c + np.arange(c)).reshape(
        cell_list.num_cells, 27 * c).astype(np.int32)
    return (upload(stencil, torch.int64, device),
            upload(cand, torch.int32, device))


def payload_to_half_pairs(payload: NeighborPayload,
                          cutoff: Optional[float] = None) -> MaskedPairs:
    """A masked half pair list (i < j) from a payload-carrying neighbor list,
    the O(N) pair source of PME direct space; deltas and distances are the
    payload's (no re-gather)."""
    n, k = payload.distances.shape
    atom1 = torch.arange(n, device=payload.distances.device)[:, None].expand(
        n, k)
    mask = payload.mask & (payload.indices > atom1)
    if cutoff is not None:
        mask = mask & (payload.distances < cutoff)
    return MaskedPairs(
        atom1=torch.where(mask, atom1, 0).reshape(-1),
        atom2=torch.where(mask, payload.indices.long(), 0).reshape(-1),
        # Payload deltas point atom -> neighbor; MaskedPairs' are
        # atom1 <- atom2, hence the sign.
        deltas=torch.where(mask[..., None], -payload.deltas, 0.0).reshape(-1, 3),
        distances=torch.where(mask, payload.distances, 0.0).reshape(-1),
        mask=mask.reshape(-1),
        num_pairs=torch.sum(mask, dtype=torch.int32))


def neighbor_list_to_pairs(nlist: NeighborList, positions: Tensor,
                           box: Optional[Tensor] = None) -> MaskedPairs:
    """A masked half pair list (i < j) from a directed neighbor list, for
    consumers that iterate over pairs (PME direct space); differentiable in
    positions."""
    n, k = nlist.indices.shape
    dev = positions.device
    atom1 = torch.arange(n, device=dev)[:, None].expand(n, k).reshape(-1)
    atom2 = nlist.indices.reshape(-1).long()
    mask = (atom2 < n) & (atom2 > atom1)
    safe2 = torch.where(mask, atom2, 0)
    deltas = (positions.index_select(0, atom1)
              - positions.index_select(0, safe2))
    if box is not None:
        deltas = minimum_image(deltas, box)
    d2 = torch.where(mask, torch.sum(deltas * deltas, -1), 1.0)
    return MaskedPairs(torch.where(mask, atom1, 0), safe2,
                       torch.where(mask[:, None], deltas, 0.0),
                       torch.where(mask, torch.sqrt(d2), 0.0), mask,
                       torch.sum(mask, dtype=torch.int32))
