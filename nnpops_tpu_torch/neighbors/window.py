"""Window-mode neighbor pipeline (port of ``nnpops_tpu.neighbors.window``):
dense per-cell radial AEV + compacted, row-tiered angular AEV.

* The radial AEV needs no per-atom neighbor list: the window radial kernel
  (``ops.cuda_window``) pairs each cell's own slots with the cell's dense
  27-cell candidate window. Cell slots are species-sub-blocked (species i
  holds slot ranks ``[sum(cell_caps[:i]), sum(cell_caps[:i+1]))`` of its
  cell) and the window is species-major, so per-species sums are
  contiguous lane slices.
* The angular AEV keeps compacted per-atom lanes. At select time the
  candidate window of a (smaller) angular cell grid is tested against the
  angular window and left-packed per species (``ops.cuda_select``); rows are
  then sorted into tiers of nested lane capacities so that most rows run
  against a smaller triple table (``ops.cuda_aev``, once per tier).

Frozen-wrap contract: at refresh time every atom is wrapped into the
primary box with a recorded box multiple (``wrap_shift``), so a slot's
position stays continuous while its atom drifts across the boundary
between refreshes; the radial window adds frozen per-(cell, stencil entry)
image shifts (``shift_planes``) instead of a per-pair minimum image. The
angular side works on raw positions with the per-pair minimum image
(``_part_deltas``). Build the cell list with ``cutoff = radial_cutoff +
skin`` and refresh before any atom moves half the skin.

Port notes:

* The JAX selection builds mirror lists (``mir``, ``_mirror_packed``) and
  permutation-gather custom VJPs (``_perm_gather*``, ``_slot_pos_gather``,
  ``_row_extract``) because XLA's scatter-add is slow on the TPU. The
  window path has none of them: every gather is an ``index_select`` and
  autograd takes its adjoint (an atomic ``index_add``). Advanced indexing
  would take PyTorch's sort-based accumulating backward, measured 70x
  slower on the payload gather on an H100. ``_mirror_packed`` and
  ``_perm_gather`` are here for the cell list's scatter-free distance
  payload (``CellList.payload_distances_from_selection``, the CFConv path),
  whose adjoint is deterministic and has no atomics.
* The 27-cell stencil window is one ``index_select`` over the static slot
  id of every window lane (``_grid_device_tables``); its adjoint is
  autograd's ``index_add``. ``STENCIL_IMPL``/``MIRROR_IMPL`` of the JAX
  package are TPU A/B knobs and are not ported.
* ``select_window(compact_impl=...)``: 'kernel' (the default, the
  left-pack of slot keys), 'mask' (the slot-space validity mask and the
  lane-index left-pack, ``ops.cuda_select``) and 'sort' (per-species lane
  sorts, plain PyTorch: the JAX package's ``lax.sort`` path, the tests'
  oracle). JAX turns 'mask' into 'sort' where its Pallas left-pack's
  triangular constant would not fit VMEM (padded widths above 2,048
  lanes); the port has no such limit and always runs 'mask'.
* ``window_features(radial_impl=...)``: 'window' (the directed 27-cell
  window kernel, ``ops.cuda_window``; the selection needs
  ``need_shift_planes=True``), 'pair' (the symmetric z-pair kernel,
  ``ops.cuda_zpair``) and 'cluster' (the cluster-pair kernel over a
  selection built with a ``cluster_plan``, ``neighbors.clusters``).
* JAX's ``.at[idx].set(..., mode='drop')`` drops writes to the sentinel
  slot ``cc + 1`` (an atom past its cell's capacity). Torch raises on
  out-of-range indices, so the port allocates the sentinel rows and slices
  them off.
"""
from __future__ import annotations

import functools
from itertools import combinations
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import box_transform
from ..ops import cuda_aev
from ..ops.aev_blocked import device_constant, upload
from ..ops.cuda_select import left_pack, left_pack_lanes, window_mask
from ..ops.cuda_window import FAR, window_radial, window_radial_plain
from ..ops.cuda_zpair import pair_radial_aev
from ..utils.profiling import span
from .blocked import (BlockedLayout, BlockedSelection, _wrap_planes,
                      payload_from_blocked)
from .cell_list import CellList, _perpendicular_widths
from .clusters import ClusterSelection, cluster_radial_features, select_clusters

Tensor = torch.Tensor


class AngTier(NamedTuple):
    """Frozen angular row tiers (see :func:`select_window`): rows sorted by
    ascending tier id within each species block; tier-0 rows keep every
    angular lane, tier-t rows only the leading ``ang_tier_caps[t-1]`` lanes
    of each species block."""
    row_order: Tensor              # [N] tiered row -> (angular-grid) sorted row
    row_atom: Tensor               # [N] tiered row -> original atom
    idx: Tuple[Tensor, ...]        # per tier [R_t, K_t] neighbor slot ids
    mask: Tuple[Tensor, ...]       # per tier [R_t, K_t] bool
    slot_rows: Tuple[Tensor, ...]  # per tier [R_t] the row's own slot
    # [ntiers-1, npres] true cumulative row counts of tiers 0..t (soft
    # failure when one exceeds the planned cumulative row capacity).
    tier_counts: Tensor
    concat_pos: Tensor             # [N] tiered row -> tier-major packed row


class WindowSelection(NamedTuple):
    """Frozen window-mode selection (refresh-scoped, like BlockedSelection).

    ``ang``: a BlockedSelection whose "radial" lanes ARE the angular window
    (``rad_caps == ang_caps``), in the slot space of the angular grid
    (``layout.ang_cell_grid``/``ang_cell_caps`` when planned, else the
    radial grid). ``rad_*``: the radial grid's slot assignment.
    ``clusters``: the cluster selection of ``radial_impl='cluster'``.
    """
    ang: BlockedSelection
    # [3, ncells, kk] radial-grid image shifts ([1, 1, 1] zeros unless
    # built with need_shift_planes).
    shift_planes: Tensor
    wrap_shift: Tensor         # [N, 3] frozen box wrap per atom
    max_cell_sp: Tensor        # [npres] true max per-(cell, species) occupancy
    # Cell-occupancy bucketing: cells permuted so the (at most
    # num_big_cells) high-occupancy cells come first; identity without it.
    cell_perm: Tensor          # [ncells]
    cell_inv_perm: Tensor      # [ncells] inverse of cell_perm
    n_big_true: Tensor         # scalar, true big-cell count
    rad_order: Tensor          # [N] radial-grid sorted row -> atom
    rad_slot_of_sorted: Tensor  # [N] (cc + 1 = past its cell's capacity)
    rad_slot_of_atom: Tensor   # [N] atom -> radial slot
    rad_slot_to_atom: Tensor   # [cc] radial slot -> atom (N = empty)
    max_cell_sp_ang: Tensor    # [npres] angular-grid occupancy max
    tier: Optional[AngTier] = None
    clusters: Optional[ClusterSelection] = None


# ---------------------------------------------------------------------------
# Host planners (numpy; their output equals the JAX package's exactly).
# ---------------------------------------------------------------------------

def plan_window_cells(positions, box, species, present,
                      cutoff: float, margin: float = 1.15,
                      pad_multiple: int = 8):
    """(cell_grid, cell_caps, small_caps, num_big_cells) for
    species-sub-blocked window slots, or all-None when the box is under 3
    cells wide.

    ``pad_multiple``: alignment of the total cell block (8 for the radial
    grid, 1 for the angular candidate grid). ``small_caps``/
    ``num_big_cells``: cell-occupancy bucketing. Most cells sit near the
    mean occupancy while the capacities hold the max, so cells that fit
    ``small_caps`` run the radial kernel with packed center rows; at most
    ``num_big_cells`` cells (the observed count with 1.5x headroom) may
    exceed them, a reported soft failure beyond that."""
    box_np = np.asarray(box, np.float64)
    widths = _perpendicular_widths(box_np)
    nc = np.maximum(np.floor(widths / cutoff).astype(int), 1)
    if (nc < 3).any():
        return None, None, None, None
    nx, ny, nz = (int(x) for x in nc)
    ncells = nx * ny * nz
    inv = np.linalg.inv(box_np)
    frac = np.asarray(positions, np.float64) @ inv
    frac -= np.floor(frac)
    c3 = np.minimum((frac * nc).astype(int), nc - 1)
    cid = (c3[:, 0] * ny + c3[:, 1]) * nz + c3[:, 2]
    species = np.asarray(species)
    pres_index = {s: i for i, s in enumerate(present)}
    sp_idx = np.array([pres_index[int(s)] for s in species])
    npres = len(present)
    counts = np.bincount(cid * npres + sp_idx,
                         minlength=ncells * npres).reshape(ncells, npres)
    caps = [int(np.ceil(m * margin)) + 1 for m in counts.max(axis=0)]
    caps[-1] += (-sum(caps)) % pad_multiple
    caps = tuple(caps)

    # Small-class capacities minimizing the expected center rows (rows
    # padded to multiples of 8, as the reference planner counts them).
    c_full = -(-sum(caps) // 8) * 8
    best = (c_full, None, None)
    for pct in (50, 60, 70, 80, 90):
        small = tuple(
            min(int(np.ceil(np.percentile(counts[:, s], pct))) + 1, caps[s])
            for s in range(npres))
        frac_big = float((counts > np.asarray(small)).any(axis=1).mean())
        c_small = -(-sum(small) // 8) * 8
        cost = frac_big * c_full + (1.0 - frac_big) * c_small
        if cost < best[0] - 0.5:
            best = (cost, small, frac_big)
    _, small, frac_big = best
    if small is None:
        return (nx, ny, nz), caps, None, None
    n_big = int(np.ceil(frac_big * ncells * 1.5)) + 8
    n_big = min(-(-n_big // 8) * 8, ncells)
    if n_big >= ncells * 3 // 5:
        return (nx, ny, nz), caps, None, None
    return (nx, ny, nz), caps, small, n_big


def _num_triples(caps) -> int:
    """Triple-table size for per-species angular capacities (the
    enumeration of ``aev_blocked.build_triple_tables``)."""
    t = 0
    for i, ci in enumerate(caps):
        t += ci * (ci - 1) // 2
        for cj in caps[i + 1:]:
            t += ci * cj
    return t


def plan_angular_tiers(positions, box, species, present, ang_window: float,
                       ang_caps: Tuple[int, ...]):
    """(ang_tier_caps, ang_tier_rows) for angular row tiering, or
    (None, None) when a split does not pay.

    The angular kernel's cost is rows x triple-table size, and the caps
    hold the max per-species count while most rows sit near the mean; rows
    that fit smaller caps run against a quadratically smaller table. The
    planner searches two- to four-tier ladders of nested percentile caps
    for the least expected sum of rows x triples, counting triples padded
    to multiples of 128 as the reference planner does."""
    positions = np.asarray(positions, np.float64)
    species = np.asarray(species)
    n = len(positions)
    npres = len(present)
    pres_index = {s: i for i, s in enumerate(present)}
    sp_idx = np.array([pres_index[int(s)] for s in species])
    box_np = np.asarray(box, np.float64) if box is not None else None
    counts = np.zeros((n, npres), np.int64)
    w2 = float(ang_window) ** 2
    if box_np is not None:
        widths = _perpendicular_widths(box_np)
        nc = np.maximum((widths // ang_window).astype(int), 1)
        if (nc < 3).any():
            nc = np.array([1, 1, 1])
    else:
        nc = np.array([1, 1, 1])
    ncell = int(np.prod(nc))
    if ncell == 1:
        cells = {0: np.arange(n)}
        stencil = {0: [0]}
    else:
        inv = np.linalg.inv(box_np)
        frac = positions @ inv
        frac -= np.floor(frac)
        c3 = np.minimum((frac * nc).astype(int), nc - 1)
        cid = (c3[:, 0] * nc[1] + c3[:, 1]) * nc[2] + c3[:, 2]
        order = np.argsort(cid, kind='stable')
        bounds = np.searchsorted(cid[order], np.arange(ncell + 1))
        cells = {c: order[bounds[c]:bounds[c + 1]] for c in range(ncell)}
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
    for c, atoms in cells.items():
        if len(atoms) == 0:
            continue
        cand = np.concatenate([cells[q] for q in stencil[c]])
        delta = positions[cand][None, :, :] - positions[atoms][:, None, :]
        if box_np is not None:
            delta = delta - np.round(delta[..., 2:3] / box_np[2, 2]) * box_np[2]
            delta = delta - np.round(delta[..., 1:2] / box_np[1, 1]) * box_np[1]
            delta = delta - np.round(delta[..., 0:1] / box_np[0, 0]) * box_np[0]
        d2 = (delta ** 2).sum(-1)
        d2[atoms[:, None] == cand[None, :]] = np.inf
        within = d2 < w2
        for s in range(npres):
            counts[atoms, s] = within[:, sp_idx[cand] == s].sum(1)

    def _padded_triples(caps_t):
        return -(-max(_num_triples(caps_t), 1) // 128) * 128

    t_full = _padded_triples(ang_caps)
    pcts = (40, 50, 60, 70, 80, 90)

    def _grow_to_pad(caps_t):
        # Extra lanes inside the same padded triple count are free and let
        # more rows fit the smaller tier.
        caps_l = list(caps_t)
        padded = _padded_triples(tuple(caps_l))
        improved = True
        while improved:
            improved = False
            for s in range(npres):
                if caps_l[s] < ang_caps[s]:
                    trial = list(caps_l)
                    trial[s] += 1
                    if _padded_triples(tuple(trial)) == padded:
                        caps_l = trial
                        improved = True
        return tuple(caps_l)

    def caps_at(pct):
        return _grow_to_pad(tuple(
            min(int(np.ceil(np.percentile(counts[:, s], pct))) + 1,
                ang_caps[s]) for s in range(npres)))

    def fits(caps_t):
        return (counts <= np.asarray(caps_t)).all(axis=1)

    # Each extra tier must beat the incumbent by 5 %.
    best = (float(t_full), None)
    for depth in (1, 2, 3):
        for ps in combinations(sorted(pcts), depth):
            capsl = [caps_at(p) for p in sorted(ps, reverse=True)]
            prev, ok = ang_caps, True
            for ct in capsl:                     # strictly nested ladder
                if ct == prev or any(a > b for a, b in zip(ct, prev)):
                    ok = False
                    break
                prev = ct
            if not ok:
                continue
            fs_l = [float(fits(ct).mean()) for ct in capsl]
            cost = (1.0 - fs_l[0]) * t_full
            for i in range(depth):
                frac = (fs_l[i] - fs_l[i + 1]) if i + 1 < depth else fs_l[i]
                cost += frac * _padded_triples(capsl[i])
            if cost < best[0] * 0.95:
                best = (cost, tuple(capsl))
    _, tiers = best
    if tiers is None:
        return None, None
    caps_all = (ang_caps,) + tiers
    ntiers = len(caps_all)
    t_of = np.zeros(n, np.int64)
    for t in range(1, ntiers):
        t_of += fits(caps_all[t]).astype(np.int64)
    # Planned row capacities of tiers 0..ntiers-2 (the last tier takes the
    # remainder), 1.5x headroom, clamped so the remainder stays >= 0.
    sp_counts = np.array([(sp_idx == i).sum() for i in range(npres)])
    tier_rows = []
    cum = np.zeros(npres, np.int64)
    for t in range(ntiers - 1):
        rows_t = []
        for i in range(npres):
            cnt = int(((t_of == t) & (sp_idx == i)).sum())
            cap = min(int(np.ceil(cnt * 1.5)) + 8,
                      int(sp_counts[i] - cum[i]))
            rows_t.append(cap)
        cum += np.asarray(rows_t)
        tier_rows.append(tuple(rows_t))
    # Drop trailing tiers the planned rows already exhaust (tiny systems).
    while tiers and int((sp_counts - cum).sum()) == 0:
        cum -= np.asarray(tier_rows[-1])
        tiers = tiers[:-1]
        tier_rows = tier_rows[:-1]
    if not tiers:
        return None, None
    return tiers, tuple(tier_rows)


# ---------------------------------------------------------------------------
# Static tables.
# ---------------------------------------------------------------------------

_OFFSETS = np.array(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                indexing='ij')).reshape(3, 27).T   # [27, 3]


@functools.lru_cache(maxsize=16)
def _window_tables(ncells3: Tuple[int, int, int]) -> Tuple[np.ndarray, ...]:
    """Per cell grid: wrap factors [ncells, 27, 3] (the box multiple each
    stencil entry crosses) and the stencil [ncells, 27] (flat cell id of
    entry e = (ox+1)*9 + (oy+1)*3 + (oz+1))."""
    nx, ny, nz = ncells3
    cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing='ij')
    coords = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], -1)
    tot = coords[:, None, :] + _OFFSETS[None, :, :]
    n3 = np.array([nx, ny, nz])
    f27 = np.floor_divide(tot, n3).astype(np.float32)
    wrapped = np.mod(tot, n3)
    stencil = ((wrapped[:, :, 0] * ny + wrapped[:, :, 1]) * nz
               + wrapped[:, :, 2]).astype(np.int64)
    return f27, stencil


@functools.lru_cache(maxsize=32)
def _lane_tables(cell_caps: Tuple[int, ...]):
    """(entry_of_lane [kk], slotoff_of_lane [kk]) of a species-major window:
    lane j of cell ``cl`` holds slot ``stencil[cl, entry[j]] * c +
    slotoff[j]``."""
    offs = np.cumsum((0,) + tuple(cell_caps))[:-1]
    entry, slotoff = [], []
    for s, cs in enumerate(cell_caps):
        entry.append(np.repeat(np.arange(27), cs))
        slotoff.append(np.tile(np.arange(cs), 27) + offs[s])
    return (np.concatenate(entry).astype(np.int64),
            np.concatenate(slotoff).astype(np.int64))


@functools.lru_cache(maxsize=32)
def _tier_rows_static(present_counts: Tuple[int, ...],
                      planned: Tuple[Tuple[int, ...], ...]):
    """Per-tier per-species row counts: the planned capacities for tiers
    0..T-2, the remainder for the last tier."""
    tier_rows = [tuple(int(x) for x in p) for p in planned]
    tier_rows.append(tuple(
        int(cnt) - sum(tr[i] for tr in tier_rows)
        for i, cnt in enumerate(present_counts)))
    return tuple(tier_rows)


def _tier_static(present_counts: Tuple[int, ...],
                 tier_rows: Tuple[Tuple[int, ...], ...]):
    """(tier_tot, concat_pos): rows are species blocks (sizes
    ``present_counts``), each cut into consecutive per-tier segments of
    ``tier_rows[t][i]`` rows; ``concat_pos`` maps a tiered row to its row in
    the tier-major concatenation [all tier-0 rows | all tier-1 rows | ...]."""
    starts = np.cumsum((0,) + present_counts)[:-1]
    ntiers = len(tier_rows)
    tier_tot = [int(sum(tr)) for tr in tier_rows]
    tier_base = np.cumsum([0] + tier_tot)
    cum_sp = [np.cumsum((0,) + tuple(tr))[:-1] for tr in tier_rows]
    concat_pos = np.empty(sum(present_counts), np.int64)
    for i, st in enumerate(starts):
        off = st
        for t in range(ntiers):
            r = tier_rows[t][i]
            concat_pos[off:off + r] = (tier_base[t] + cum_sp[t][i]
                                       + np.arange(r))
            off += r
    return tier_tot, concat_pos


@functools.lru_cache(maxsize=32)
def _tier_device_tables(present_counts: Tuple[int, ...],
                        planned: Tuple[Tuple[int, ...], ...],
                        device: torch.device):
    """(cum_rows [ntiers + 1, npres], concat_pos [N] on ``device``) of
    :func:`_tier_static`, made once per species counts, planned tier rows
    and device: both depend on nothing a selection measures."""
    tier_rows = _tier_rows_static(present_counts, planned)
    _, concat_pos = _tier_static(present_counts, tier_rows)
    cum_rows = np.zeros((len(tier_rows) + 1, len(present_counts)), np.int64)
    for t, rows in enumerate(tier_rows):
        cum_rows[t + 1] = cum_rows[t] + np.asarray(rows)
    return cum_rows, upload(concat_pos, torch.int64, device)


@functools.lru_cache(maxsize=32)
def _grid_device_tables(grid3: Tuple[int, int, int],
                        cell_caps: Tuple[int, ...], device: torch.device):
    """(wrap factors [ncells, 27, 3] f32, candidate slot id of every window
    lane [ncells, kk]) on ``device``, made once. Gathering the cell slots
    by the second builds the species-major windows: species s owns the lanes
    ``[27 * off_s, 27 * (off_s + cs))``, stencil-entry-major."""
    f27, stencil = _window_tables(grid3)
    entry, slotoff = _lane_tables(cell_caps)
    cand_slot = stencil[:, entry] * sum(cell_caps) + slotoff[None, :]
    return (upload(f27, torch.float32, device),
            upload(cand_slot, torch.int64, device))


@functools.lru_cache(maxsize=16)
def _device_stencil(grid3: Tuple[int, int, int],
                    device: torch.device) -> Tensor:
    """The stencil ``[ncells, 27]`` of ``_window_tables`` on ``device``."""
    return upload(_window_tables(grid3)[1], torch.int64, device)


def _shift_planes(f27: Tensor, box: Tensor,
                  cell_caps: Tuple[int, ...]) -> Tensor:
    """Frozen image shift of every window lane ``[3, ncells, kk]``."""
    shift27 = box_transform(f27, box).permute(2, 0, 1)       # [3, cells, 27]
    return torch.cat([torch.repeat_interleave(shift27, cs, dim=2)
                      for cs in cell_caps], 2)


def ang_as_rad_layout(layout: BlockedLayout) -> BlockedLayout:
    """The angular window as a BlockedLayout whose 'radial' lanes are the
    angular lanes (window mode keeps no radial lanes)."""
    return BlockedLayout(num_species=layout.num_species,
                         present=layout.present,
                         rad_caps=layout.ang_caps, ang_caps=layout.ang_caps)


def tier_layouts(layout: BlockedLayout):
    """Per-tier kernel layouts: tier 0 the full angular caps, tier t
    ``ang_tier_caps[t-1]`` as both radial and angular caps."""
    lays = [ang_as_rad_layout(layout)]
    for caps_t in layout.ang_tier_caps:
        lays.append(BlockedLayout(num_species=layout.num_species,
                                  present=layout.present,
                                  rad_caps=caps_t, ang_caps=caps_t))
    return lays


def _check_window_config(cell_list: CellList, layout: BlockedLayout) -> None:
    if layout.cell_caps is None or layout.cell_grid is None:
        raise ValueError('window mode needs a layout planned with cell '
                         'capacities (ANIModel.with_blocked_layout('
                         "impl='window'))")
    if not cell_list.use_cells:
        raise ValueError('window mode requires a cell decomposition '
                         '(>= 3 cells per axis); use aev_impl="pallas" for '
                         'small or non-periodic systems')
    if tuple(cell_list.ncells) != tuple(layout.cell_grid):
        raise ValueError(f'cell grid mismatch: cell list {cell_list.ncells} '
                         f'vs planned {layout.cell_grid}; build the cell '
                         'list with ANIModel.create_cell_list')
    if cell_list.cell_capacity != sum(layout.cell_caps):
        raise ValueError(f'cell capacity mismatch: cell list '
                         f'{cell_list.cell_capacity} vs planned '
                         f'{sum(layout.cell_caps)}; build the cell list '
                         'with ANIModel.create_cell_list')


# ---------------------------------------------------------------------------
# Selection (every refresh; no gradient).
# ---------------------------------------------------------------------------

def _scatter(size: int, index: Tensor, values: Tensor, fill) -> Tensor:
    """``full(size, fill).at[index].set(values, mode='drop')`` for indices
    in ``[0, size + 1]`` (the sentinel rows take the dropped writes)."""
    out = torch.full((size + 2,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    return out.index_copy(0, index, values)[:size]


def _grid_sort(p_w: Tensor, inv_box: Tensor, sp_idx: Tensor,
               grid3: Tuple[int, int, int], cell_caps: Tuple[int, ...],
               npres: int):
    """Species-sub-blocked slot assignment on one cell grid: sort by
    (cell, species), rank within each segment. ``p_w`` is wrapped into the
    primary box, ``inv_box`` is the box's inverse. Returns (order,
    slot_of_sorted, inv_order, cell_sorted, cell_sp_counts [ncells,
    npres])."""
    nx, ny, nz = grid3
    ncells = nx * ny * nz
    c = sum(cell_caps)
    cc = ncells * c
    n = p_w.shape[0]
    dev = p_w.device
    grid = device_constant((nx, ny, nz), torch.int32, dev)
    frac = box_transform(p_w, inv_box)
    frac = frac - torch.floor(frac)              # guard fp noise at 0/1
    cell3 = torch.clamp((frac * grid).to(torch.int32),
                        torch.zeros_like(grid), grid - 1).long()
    cell_id = (cell3[:, 0] * ny + cell3[:, 1]) * nz + cell3[:, 2]
    key = cell_id * npres + sp_idx
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    idx_n = torch.arange(n, device=dev)
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         sorted_key[1:] != sorted_key[:-1]])
    seg_start = torch.cummax(torch.where(new_seg, idx_n, 0), 0).values
    rank = idx_n - seg_start
    cell_sorted = sorted_key // npres
    sp_sorted = sorted_key % npres
    caps = device_constant(tuple(cell_caps), torch.int64, dev)
    offs = device_constant(
        tuple(int(x) for x in np.cumsum((0,) + tuple(cell_caps))[:-1]),
        torch.int64, dev)
    slot_of_sorted = torch.where(rank < caps[sp_sorted],
                                 cell_sorted * c + offs[sp_sorted] + rank,
                                 cc + 1)
    # index_add, not bincount: bincount on a CUDA tensor synchronises.
    counts = torch.zeros(ncells * npres, dtype=torch.int64, device=dev)
    counts = counts.index_add_(0, key, torch.ones_like(key))
    inv_order = torch.empty_like(order).index_copy_(0, order, idx_n)
    return (order, slot_of_sorted, inv_order, cell_sorted,
            counts.reshape(ncells, npres))


def _build_tier_packed(nbr: Tensor, mask: Tensor, counts: Tensor,
                       slot_of_sorted: Tensor, inv_order: Tensor,
                       go: Tensor, present_counts: Tuple[int, ...],
                       layout: BlockedLayout) -> AngTier:
    """Sort each species block's rows by tier (stable), then cut the rows
    into tiers and the tier-t rows' lanes to the tier's caps. ``go``: the
    species grouping order on the device. The row bookkeeping (``cum_rows``,
    ``concat_pos``) is made once per species counts, planned tier rows and
    device (:func:`_tier_device_tables`), so nothing here grows with N on
    the host."""
    dev = nbr.device
    caps_all = (layout.ang_caps,) + tuple(layout.ang_tier_caps)
    ntiers = len(caps_all)
    ang_offs = np.cumsum((0,) + tuple(layout.ang_caps))[:-1]
    cum_rows, concat_pos = _tier_device_tables(
        present_counts, layout.ang_tier_rows, dev)

    # Tier of a row: the smallest caps that hold its per-species counts
    # (caps are nested, so the fits are monotone).
    t_of = torch.zeros(counts.shape[0], dtype=torch.int64, device=dev)
    for ct in caps_all[1:]:
        t_of += torch.all(counts <= device_constant(tuple(ct), counts.dtype,
                                                    dev), 1).long()
    io_g = inv_order[go]
    tk = t_of[io_g]
    starts = np.cumsum((0,) + tuple(present_counts))[:-1]
    parts, cum_counts = [], []
    for st, cnt in zip(starts, present_counts):
        b = tk[int(st):int(st) + cnt]
        parts.append(int(st) + torch.argsort(b, stable=True))
        cum_counts.append(torch.stack(
            [torch.sum(b <= q) for q in range(ntiers - 1)]))
    tier_counts = torch.stack(cum_counts, 1)               # [ntiers-1, npres]
    perm = torch.cat(parts)
    io_t = io_g[perm]                                      # tiered -> sorted
    row_atom = go[perm]
    nbr_t, mask_t, srows_t = nbr[io_t], mask[io_t], slot_of_sorted[io_t]

    def split_rows(x):
        return [torch.cat([x[int(st + cum_rows[t][i]):
                             int(st + cum_rows[t + 1][i])]
                           for i, st in enumerate(starts)], 0)
                for t in range(ntiers)]

    def tier_lanes(x, caps_t):
        return torch.cat([x[:, int(ao):int(ao) + sc]
                          for ao, sc in zip(ang_offs, caps_t)], 1)

    nbr_tiers, mask_tiers = split_rows(nbr_t), split_rows(mask_t)
    idx = [nbr_tiers[0]] + [tier_lanes(nbr_tiers[t], caps_all[t])
                            for t in range(1, ntiers)]
    msk = [mask_tiers[0]] + [tier_lanes(mask_tiers[t], caps_all[t])
                             for t in range(1, ntiers)]
    return AngTier(row_order=io_t, row_atom=row_atom,
                   idx=tuple(idx), mask=tuple(msk),
                   slot_rows=tuple(split_rows(srows_t)),
                   tier_counts=tier_counts, concat_pos=concat_pos)


def _compact_window_mask(cc: int, cell_caps: Tuple[int, ...],
                         a_caps: Tuple[int, ...], cand_cells: Tensor,
                         pos_slots: Tensor, slot_of_sorted: Tensor,
                         cell_sorted: Tensor, stencil: Tensor, w2: float):
    """The 'mask' compaction: the validity test runs in slot space (one
    mask kernel over the cells' windows, no per-atom candidate gather),
    each atom takes its slot's mask row, and the left-pack packs static
    block-local lane indices. Lane l of species block s is stencil entry
    ``l // cs`` at slot offset ``l % cs``, so slot ids are rebuilt
    arithmetically. The same pairs, lane order and counts as the 'kernel'
    compaction. Returns (nbr [N, Kat], mask, counts [N, npres], ang_in_rad)
    in sorted row space."""
    c = sum(cell_caps)
    ncells = cand_cells.shape[1]
    centers = pos_slots.reshape(ncells, c, 3)
    m_slots = window_mask(cand_cells[0], cand_cells[1], cand_cells[2],
                          centers, w2, cell_caps)
    # An atom past its cell's capacity (slot cc + 1) reads a clamped row:
    # its results are invalid anyway, and the occupancy count reports it.
    m_atom = m_slots.reshape(ncells * c, 27 * c).index_select(
        0, torch.clamp(slot_of_sorted, max=ncells * c - 1))
    lanes, counts = left_pack_lanes(m_atom, [27 * cs for cs in cell_caps],
                                    a_caps)
    stencil_rows = stencil.index_select(0, cell_sorted)     # [N, 27]
    offs = np.cumsum((0,) + tuple(cell_caps))[:-1]
    krt = int(sum(a_caps))
    nbrs, masks, airs = [], [], []
    ro = 0
    for off, cs, cap in zip(offs, cell_caps, a_caps):
        ln = lanes[:, ro:ro + cap].long()
        m = ln >= 0
        li = torch.where(m, ln, 0)
        entry = li // cs                       # block-local stencil entry
        slot = (torch.gather(stencil_rows, 1, entry) * c
                + (int(off) + li - entry * cs))
        nbrs.append(torch.where(m, slot, cc))
        masks.append(m)
        airs.append(torch.where(
            m, torch.arange(ro, ro + cap, device=lanes.device)[None], krt))
        ro += cap
    return (torch.cat(nbrs, 1), torch.cat(masks, 1), counts,
            torch.cat(airs, 1))


def _compact_window(cc: int, cell_caps: Tuple[int, ...],
                    a_caps: Tuple[int, ...], valid: Tensor,
                    cand_slot_atom: Tensor):
    """The 'sort' compaction (the JAX package's ``lax.sort`` reference
    path): per species block, the valid candidates' slot ids sorted
    ascending and cut to the cap; the counts are the blocks' valid lanes.
    Lanes come out slot-ascending, not entry-major. Returns (nbr, mask,
    counts, ang_in_rad) in sorted row space."""
    big = 2 ** 31 - 1
    krt = int(sum(a_caps))
    nbr, masks, counts, air = [], [], [], []
    lo, ro = 0, 0
    for cs, cap in zip(cell_caps, a_caps):
        w = 27 * cs
        v = valid[:, lo:lo + w]
        counts.append(v.sum(1, dtype=torch.int32))
        key = torch.where(v, cand_slot_atom[:, lo:lo + w], big)
        key = torch.sort(key, dim=1).values[:, :cap]
        m = key < big
        nbr.append(torch.where(m, key, cc))
        masks.append(m)
        air.append(torch.where(
            m, torch.arange(ro, ro + cap, device=valid.device)[None], krt))
        lo += w
        ro += cap
    return (torch.cat(nbr, 1), torch.cat(masks, 1), torch.stack(counts, 1),
            torch.cat(air, 1))


COMPACT_IMPLS = ('kernel', 'mask', 'sort')


@torch.no_grad()
def select_window(cell_list: CellList, positions: Tensor, box: Tensor,
                  species, layout: BlockedLayout,
                  radial_cutoff: float, angular_cutoff: float,
                  grouping_order=None,
                  present_counts: Optional[Tuple[int, ...]] = None,
                  need_shift_planes: bool = False,
                  cluster_plan=None,
                  compact_impl: str = 'kernel') -> WindowSelection:
    """Freeze a window-mode selection.

    ``layout``: ``cell_caps``/``cell_grid`` drive the radial grid's slot
    assignment, ``ang_cell_grid``/``ang_cell_caps`` (when planned) a smaller
    angular candidate grid, ``ang_caps`` the angular compaction. With
    ``grouping_order``/``present_counts`` (the model's species grouping) and
    a layout that plans tiers, the angular rows are tiered.
    ``species`` and ``grouping_order``: host arrays (made into device
    constants) or int64 tensors on the positions' device, used as they are:
    ``ANIModel.select`` passes its device tables, made once per model and
    device, so the window selection then builds, hashes and uploads
    nothing of length N and never waits on the device.
    ``need_shift_planes``: build the radial grid's image-shift planes (only
    the directed 'window' radial kernel reads them). ``cluster_plan``: also
    freeze a cluster selection (``radial_impl='cluster'``).
    ``compact_impl``: 'kernel' (the left-pack of slot keys), 'mask' (the
    slot-space mask and the lane-index left-pack; the same lists) or 'sort'
    (per-species lane sorts; the same sets, slot-ascending lanes).
    """
    if compact_impl not in COMPACT_IMPLS:
        raise ValueError(f'compact_impl={compact_impl!r} not in '
                         f'{COMPACT_IMPLS}')
    _check_window_config(cell_list, layout)
    positions = positions.detach()
    box = box.detach()
    dev = positions.device
    n = positions.shape[0]
    ncells = cell_list.num_cells
    cell_caps = tuple(layout.cell_caps)
    npres = len(layout.present)
    c = sum(cell_caps)

    with span('select.species'):
        # inv_ex: torch.linalg.inv's numbers without its check on the host.
        inv_box = torch.linalg.inv_ex(box).inverse
        frac = box_transform(positions, inv_box)
        wrap_shift = box_transform(torch.floor(frac), box)
        p_w = positions - wrap_shift
        pres_table = np.full(layout.num_species + 1, npres, np.int64)
        for i, s in enumerate(layout.present):
            pres_table[s] = i
        if isinstance(species, Tensor):
            sp_idx = device_constant(tuple(pres_table.tolist()), torch.int64,
                                     dev).index_select(0, species)
        else:
            sp_idx = device_constant(
                tuple(pres_table[np.asarray(species, np.int64)].tolist()),
                torch.int64, dev)

    # ---- Radial grid: slot assignment only.
    grid_r = tuple(int(x) for x in cell_list.ncells)
    with span('select.grid_sort'):
        (order_r, slot_r, inv_r, cell_sorted_r,
         counts_r) = _grid_sort(p_w, inv_box, sp_idx, grid_r, cell_caps, npres)
        max_cell_sp = torch.max(counts_r, 0).values
        max_occ = torch.max(torch.sum(counts_r, 1))
        rad_slot_of_atom = torch.empty_like(slot_r).index_copy_(0, order_r,
                                                                slot_r)
        rad_slot_to_atom = _scatter(ncells * c, slot_r, order_r, n)

    with span('select.big_cells'):
        if layout.small_caps is not None:
            is_big = torch.any(counts_r > device_constant(
                tuple(layout.small_caps), counts_r.dtype, dev), 1)
            cell_perm = torch.argsort((~is_big).to(torch.int8), stable=True)
            n_big_true = torch.sum(is_big)
        else:
            cell_perm = torch.arange(ncells, device=dev)
            n_big_true = torch.zeros((), dtype=torch.int64, device=dev)
        cell_inv_perm = torch.empty_like(cell_perm).index_copy_(
            0, cell_perm, torch.arange(ncells, device=dev))
        if need_shift_planes:
            f27_r, _ = _grid_device_tables(grid_r, cell_caps, dev)
            shift_planes = _shift_planes(f27_r, box, cell_caps)
        else:
            shift_planes = positions.new_zeros(1, 1, 1)

    # ---- Angular grid: candidate window, validity, left-pack.
    if layout.ang_cell_grid is not None and layout.ang_cell_caps is not None:
        a_grid = tuple(int(x) for x in layout.ang_cell_grid)
        a_ccaps = tuple(int(x) for x in layout.ang_cell_caps)
    else:
        a_grid, a_ccaps = grid_r, cell_caps
    c_a = sum(a_ccaps)
    ncells_a = int(np.prod(a_grid))
    cc_a = ncells_a * c_a
    if a_grid == grid_r and a_ccaps == cell_caps:
        order, slot_of_sorted, inv_order = order_r, slot_r, inv_r
        cell_sorted, counts_a = cell_sorted_r, counts_r
    else:
        with span('select.grid_sort'):
            (order, slot_of_sorted, inv_order, cell_sorted,
             counts_a) = _grid_sort(p_w, inv_box, sp_idx, a_grid, a_ccaps,
                                   npres)
    max_cell_sp_ang = torch.max(counts_a, 0).values
    skin = cell_list.cutoff - radial_cutoff
    ang_window = angular_cutoff + max(skin, 0.0)
    a_caps = tuple(layout.ang_caps)
    w2 = ang_window * ang_window
    with span('select.candidates'):
        pos_sorted = p_w[order]
        pos_slots = _scatter(cc_a, slot_of_sorted, pos_sorted, FAR)
        f27_a, cand_slot = _grid_device_tables(a_grid, a_ccaps, dev)
        cand_cells = (pos_slots.t().index_select(1, cand_slot.reshape(-1))
                      .reshape(3, ncells_a, cand_slot.shape[1])
                      + _shift_planes(f27_a, box, a_ccaps))  # [3, cells, kk_a]
        if compact_impl != 'mask':
            cand_pos = cand_cells.permute(1, 0, 2)[cell_sorted]  # [N, 3, kk_a]
            d = cand_pos - pos_sorted[:, :, None]
            d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
            cand_slot_atom = cand_slot[cell_sorted]              # [N, kk_a]
            valid = (d2 < w2) & (cand_slot_atom != slot_of_sorted[:, None])

    with span('select.left_pack'):
        if compact_impl == 'mask':
            nbr, m, counts, air = _compact_window_mask(
                cc_a, a_ccaps, a_caps, cand_cells, pos_slots, slot_of_sorted,
                cell_sorted, _device_stencil(a_grid, dev), w2)
        elif compact_impl == 'kernel':
            keys = torch.where(valid, cand_slot_atom, -1).to(torch.int32)
            packed, counts = left_pack(keys, [27 * cs for cs in a_ccaps],
                                       a_caps)
            m = packed >= 0
            nbr = torch.where(m, packed.long(), cc_a)
            krt = int(sum(a_caps))
            air = torch.where(m, torch.arange(krt, device=dev)[None], krt)
        else:
            nbr, m, counts, air = _compact_window(cc_a, a_ccaps, a_caps,
                                                  valid, cand_slot_atom)
    max_ang = torch.max(counts, 0).values.long()
    bsel = BlockedSelection(
        order=order, slot_of_sorted=slot_of_sorted, inv_order=inv_order,
        slot_to_atom=_scatter(cc_a + 1, slot_of_sorted, order, n),
        nbr_rad=nbr, rad_mask=m, nbr_ang=nbr, ang_mask=m,
        max_rad=max_ang, max_ang=max_ang, max_cell_occupancy=max_occ,
        ang_in_rad=air)
    tier = None
    if (grouping_order is not None and present_counts is not None
            and layout.ang_tier_caps is not None
            and layout.ang_tier_rows is not None):
        with span('select.tiers'):
            go = (grouping_order if isinstance(grouping_order, Tensor)
                  else device_constant(tuple(int(x) for x in grouping_order),
                                       torch.int64, dev))
            tier = _build_tier_packed(nbr, m, counts, slot_of_sorted,
                                      inv_order, go,
                                      tuple(int(x) for x in present_counts),
                                      layout)
    clusters = None
    if cluster_plan is not None:
        clusters = select_clusters(positions, box, species, cluster_plan,
                                   radial_cutoff, skin=skin)
    return WindowSelection(
        ang=bsel, shift_planes=shift_planes, wrap_shift=wrap_shift,
        max_cell_sp=max_cell_sp, cell_perm=cell_perm,
        cell_inv_perm=cell_inv_perm, n_big_true=n_big_true,
        rad_order=order_r, rad_slot_of_sorted=slot_r,
        rad_slot_of_atom=rad_slot_of_atom, rad_slot_to_atom=rad_slot_to_atom,
        max_cell_sp_ang=max_cell_sp_ang, tier=tier, clusters=clusters)


# ---------------------------------------------------------------------------
# Features (every step; differentiable in positions).
# ---------------------------------------------------------------------------

def _part_deltas(gathered: Tensor, centers: Tensor, mask: Tensor,
                 box: Optional[Tensor]) -> Tensor:
    """Minimum-imaged coordinate planes ``[3, R, K]`` from one tier's
    gathered neighbor positions ``[R, K, 3]`` and its centers ``[R, 3]``."""
    dx = gathered[..., 0] - centers[:, 0:1]
    dy = gathered[..., 1] - centers[:, 1:2]
    dz = gathered[..., 2] - centers[:, 2:3]
    if box is not None:
        dx, dy, dz = _wrap_planes(dx, dy, dz, box)
    return torch.where(mask[None], torch.stack([dx, dy, dz]), 0.0)


def _angular(deltas, mask, basis, layout, plain: bool) -> Tensor:
    width = deltas.shape[2]
    if plain:
        return cuda_aev.place_angular(cuda_aev.angular_aev_plain(
            deltas, mask, basis, layout, width), basis, layout)
    return cuda_aev.angular_aev(deltas, mask, basis, layout, width)


def _tiered_angular(positions: Tensor, box: Tensor, wsel: WindowSelection,
                    basis, layout: BlockedLayout, cc: int, plain: bool):
    """Angular AEV with the rows of tier t against tier t's triple table;
    ``cc`` is the angular grid's slot count. Returns (row_atom, angular)
    with the rows in tiered order."""
    sel, t = wsel.ang, wsel.tier
    slots = positions.new_zeros(cc + 2, 3).index_copy(
        0, sel.slot_of_sorted, positions.index_select(0, sel.order))
    angs = []
    for lay, idx, mask, srows in zip(tier_layouts(layout), t.idx, t.mask,
                                     t.slot_rows):
        gathered = slots.index_select(0, idx.reshape(-1)).reshape(
            idx.shape[0], idx.shape[1], 3)
        deltas = _part_deltas(gathered, slots.index_select(0, srows), mask,
                              box)
        angs.append(_angular(deltas, mask, basis, lay, plain))
    return t.row_atom, torch.cat(angs, 0).index_select(0, t.concat_pos)


RADIAL_IMPLS = ('window', 'pair', 'cluster')


def window_features(cell_list: CellList, positions: Tensor, box: Tensor,
                    wsel: WindowSelection, basis, layout: BlockedLayout,
                    atom_order: Optional[Tensor] = None,
                    plain: bool = False,
                    radial_impl: str = 'window') -> Tensor:
    """Full AEV ``[N, aev_length]`` (radial [S*R] | angular [P*A]) for
    window mode, differentiable in ``positions``.

    ``atom_order``: atom index per output row (the model's species
    grouping); default the original order. With tiers the rows come out in
    the tiers' order of that grouping instead (species blocks preserved).
    ``plain``: run the kernels' plain PyTorch versions on any device (the
    reference a step through the kernels is held against).
    ``radial_impl``: 'window' (the directed 27-cell window kernel; it
    honours cell-occupancy bucketing and needs a selection built with
    ``need_shift_planes=True``), 'pair' (the symmetric z-pair kernel, each
    atom pair's Gaussians evaluated once) or 'cluster' (the cluster-pair
    kernel; needs a selection built with the layout's ``cluster_plan``)."""
    if radial_impl not in RADIAL_IMPLS:
        raise ValueError(f'radial_impl={radial_impl!r} not in {RADIAL_IMPLS}')
    n = positions.shape[0]
    ncells = cell_list.num_cells
    cell_caps = tuple(layout.cell_caps)
    c = sum(cell_caps)
    cc = ncells * c
    if layout.ang_cell_grid is not None and layout.ang_cell_caps is not None:
        cc_a = int(np.prod(layout.ang_cell_grid)) * sum(layout.ang_cell_caps)
    else:
        cc_a = cc

    if wsel.tier is not None:
        row_atom, angular = _tiered_angular(positions, box, wsel, basis,
                                            layout, cc_a, plain)
    else:
        sel = wsel.ang
        row_atom = (atom_order if atom_order is not None
                    else torch.arange(n, device=positions.device))
        pay = payload_from_blocked(cell_list, positions, box, sel,
                                   rad_only=True,
                                   row_order=sel.inv_order[row_atom],
                                   num_slots=cc_a)
        angular = _angular(pay.rad_deltas, pay.ang_mask, basis,
                           ang_as_rad_layout(layout), plain)

    if radial_impl == 'cluster':
        if wsel.clusters is None or layout.cluster_plan is None:
            raise ValueError("radial_impl='cluster' needs a selection built "
                             'with a cluster_plan')
        radial_rows = cluster_radial_features(
            positions, wsel.clusters, layout.cluster_plan, basis, row_atom,
            plain=plain)
        return _expand_radial_rows(radial_rows, angular, layout, basis)
    if radial_impl == 'pair':
        rad_slots = pair_radial_aev(
            _radial_slots(positions, wsel), box, cell_list.ncells, cell_caps,
            basis.radial_cutoff, basis.radial_eta, basis.radial_rs,
            basis.torchani, plain=plain)
        return _radial_rows_from_slots(rad_slots, angular, wsel, layout,
                                       basis, cc, row_atom)
    if wsel.shift_planes.shape[1] != ncells:
        raise ValueError("radial_impl='window' needs a selection built with "
                         'need_shift_planes=True')

    # ---- Radial: the 27-cell window of the radial grid, capacity-free.
    win, centers = radial_window_inputs(cell_list, positions, wsel, layout)
    radial_fn = window_radial_plain if plain else window_radial
    args = (basis.radial_cutoff, basis.radial_eta, basis.radial_rs,
            cell_caps, basis.torchani)
    if layout.small_caps is None or layout.num_big_cells is None:
        rad_slots = radial_fn(win[0], win[1], win[2], centers, *args)
    else:
        # Cell-occupancy bucketing: the big cells (front of the frozen
        # permutation) run at full center rows, the rest with their species
        # blocks cut to small_caps rows.
        nb, sc = layout.num_big_cells, tuple(layout.small_caps)
        offs = np.cumsum((0,) + cell_caps)[:-1]
        winp = win.index_select(1, wsel.cell_perm)
        ctrp = centers.index_select(0, wsel.cell_perm)
        rad_a = radial_fn(winp[0, :nb], winp[1, :nb], winp[2, :nb],
                          ctrp[:nb], *args)
        ctr_small = torch.cat([ctrp[nb:, int(o):int(o) + s]
                               for o, s in zip(offs, sc)], 1)
        rad_b = radial_fn(winp[0, nb:], winp[1, nb:], winp[2, nb:], ctr_small,
                          *args, center_caps=sc)
        sc_offs = np.cumsum((0,) + sc)[:-1]
        pieces = []
        for so, s, cs in zip(sc_offs, sc, cell_caps):
            blk = rad_b[:, int(so):int(so) + s]
            if cs > s:
                blk = torch.cat([blk, blk.new_zeros(blk.shape[0], cs - s,
                                                    blk.shape[2])], 1)
            pieces.append(blk)
        rad_perm = torch.cat([rad_a, torch.cat(pieces, 1)], 0)
        rad_slots = rad_perm.index_select(0, wsel.cell_inv_perm)
    return _radial_rows_from_slots(rad_slots, angular, wsel, layout, basis,
                                   cc, row_atom)


def radial_window_inputs(cell_list: CellList, positions: Tensor,
                         wsel: WindowSelection, layout: BlockedLayout):
    """The window radial kernel's inputs on the radial grid: candidate
    planes ``[3, ncells, kk]`` (every cell's 27-cell species-major window of
    slot positions in the frozen wrap, one ``index_select`` over the static
    lane table, frozen image shifts added; empty slots at FAR) and the
    cells' own slots as centers ``[ncells, c, 3]``."""
    grid = tuple(int(x) for x in cell_list.ncells)
    cell_caps = tuple(layout.cell_caps)
    slots = _radial_slots(positions, wsel)                      # [cc, 3]
    _, cand_slot = _grid_device_tables(grid, cell_caps, positions.device)
    win = (slots.t().index_select(1, cand_slot.reshape(-1))
           .reshape(3, cell_list.num_cells, cand_slot.shape[1])
           + wsel.shift_planes)
    return win, slots.reshape(cell_list.num_cells, sum(cell_caps), 3)


def _radial_slots(positions: Tensor, wsel: WindowSelection) -> Tensor:
    """The radial grid's slot positions ``[cc, 3]`` in the frozen wrap,
    empty slots at FAR (one ``index_select``, adjoint ``index_add``)."""
    p_w = positions - wsel.wrap_shift
    p_ext = torch.cat([p_w, p_w.new_full((1, 3), FAR)])
    return p_ext.index_select(0, wsel.rad_slot_to_atom)


def _radial_rows_from_slots(rad_slots: Tensor, angular: Tensor,
                            wsel: WindowSelection, layout: BlockedLayout,
                            basis, cc: int, row_atom: Tensor) -> Tensor:
    """Slot-space radial AEV -> per-atom rows (``row_atom``: atom per output
    row) in the full [S*R] species layout, concatenated with the angular
    block. The row gather is an ``index_select`` (adjoint ``index_add``)."""
    rad_flat = rad_slots.reshape(cc, len(layout.present) * basis.num_radial)
    row_slots = torch.clamp(wsel.rad_slot_of_atom[row_atom], max=cc - 1)
    return _expand_radial_rows(rad_flat.index_select(0, row_slots), angular,
                               layout, basis)


def _expand_radial_rows(radial_rows: Tensor, angular: Tensor,
                        layout: BlockedLayout, basis) -> Tensor:
    """[N, P*R] present-species radial rows -> the full [S*R] layout (zero
    blocks for absent species), concatenated with the angular block."""
    num_r = basis.num_radial
    pieces = []
    for s in range(basis.num_species):
        if s in layout.present:
            i = layout.present.index(s)
            pieces.append(radial_rows[:, i * num_r:(i + 1) * num_r])
        else:
            pieces.append(radial_rows.new_zeros(radial_rows.shape[0], num_r))
    return torch.cat(pieces + [angular], 1)


# ---------------------------------------------------------------------------
# Mirror pairing and the permutation gather (the cell list's distance
# payload, ``CellList.payload_distances_from_selection``).
# ---------------------------------------------------------------------------

def _mirror_packed(segments, cc: int,
                   grid3: Optional[Tuple[int, int, int]] = None,
                   c_per_cell: Optional[int] = None) -> Tuple[Tensor, ...]:
    """Mirror indices in the packed tier-major flat space ([tier-0 rows x
    K0 | tier-1 rows x K1 | ...]): for every valid directed entry
    (slot s1 -> slot s2) the flat index of its reverse entry (s2 -> s1),
    ``tot`` (the flat size) for invalid entries. ``segments``: per tier
    (slot_rows [R_t], idx [R_t, K_t], mask [R_t, K_t]). int32 outputs, equal
    to the JAX package's.

    With ``grid3``/``c_per_cell`` (the slot space's cell grid and slots per
    cell) each entry's key encodes the neighbor RELATIVE to the center's
    27-cell stencil (slot * 27c + entry * c + slot offset, below 2^31 when
    ``cc * 27c`` is), the unordered key q = min(forward, reverse) is
    arithmetic (the reverse stencil entry is 26 - e), and one stable sort by
    q lands the two directions of every pair adjacent; the partner is the
    neighbor in the sorted order. The JAX package inverts that sorted order
    with a second key-value sort (a TPU scatter is slow); here it is one
    ``index_copy`` through the permutation, the same values. Without grid
    information the pair keys (s1, s2) and (s2, s1) are sorted in int64
    (the JAX package's uint32 keys, or its two-key sort where those
    overflow, give the same order) and the two orders are matched rank by
    rank.

    Each valid entry's reverse must be present: a row that lost lanes to
    overflow breaks the pairing (the soft failure its counts report)."""
    shapes = [tuple(idx.shape) for _, idx, _ in segments]
    sizes = [r * k for r, k in shapes]
    tot = sum(sizes)
    s1 = torch.cat([sr.long()[:, None].expand(idx.shape).reshape(-1)
                    for sr, idx, _ in segments])
    s2 = torch.cat([idx.long().reshape(-1) for _, idx, _ in segments])
    valid = torch.cat([m.reshape(-1) for _, _, m in segments]) & (s1 <= cc)
    use_rel = (grid3 is not None and c_per_cell is not None
               and cc * 27 * c_per_cell < 2 ** 31 - 1)
    if use_rel:
        nx, ny, nz = (int(x) for x in grid3)
        c = int(c_per_cell)
        kk = 27 * c
        s1c = torch.clamp(s1, max=cc - 1)   # clamp sentinels (masked anyway)
        s2c = torch.clamp(s2, max=cc - 1)
        c1, c2 = s1c // c, s2c // c
        so1, so2 = s1c - c1 * c, s2c - c2 * c

        def axis_off(a1, a2, na):
            d = (a2 - a1 + 1) % na          # 0 -> -1, 1 -> 0, 2 -> +1
            return torch.where(d > 2, 1, d)  # na-1 aliases never occur (na>=3)

        e = (axis_off(c1 // (ny * nz), c2 // (ny * nz), nx) * 9
             + axis_off((c1 // nz) % ny, (c2 // nz) % ny, ny) * 3
             + axis_off(c1 % nz, c2 % nz, nz))   # stencil entry of s2 in s1's
        q = torch.minimum(s1c * kk + e * c + so2, s2c * kk + (26 - e) * c + so1)
        qv = torch.where(valid, q, 2 ** 31 - 1)
        if tot % 2:                         # adjacent pairing needs even
            qv = torch.cat([qv, qv.new_full((1,), 2 ** 31 - 1)])
        fs = torch.sort(qv, stable=True).indices
        partner = fs.reshape(-1, 2).flip(1).reshape(-1)
        mir = torch.empty_like(fs).index_copy_(0, fs, partner)[:tot]
        mir = torch.where(valid, torch.clamp(mir, max=tot), tot)
    else:
        base = cc + 2
        big = base * base
        v1 = torch.sort(torch.where(valid, s1 * base + s2, big),
                        stable=True).indices
        v2 = torch.sort(torch.where(valid, s2 * base + s1, big),
                        stable=True).indices
        # mir[v1[k]] = v2[k]: v1 is a permutation, so this is exact.
        mir = torch.empty_like(v1).index_copy_(0, v1, v2)
        mir = torch.where(valid, mir, tot)
    mir = mir.to(torch.int32)
    out, off = [], 0
    for (r, k), sz in zip(shapes, sizes):
        out.append(mir[off:off + sz].reshape(r, k))
        off += sz
    return tuple(out)


class _PermGather(torch.autograd.Function):
    """``x[perm]`` for a PERMUTATION ``perm``; the adjoint is the gather
    ``g[inv_perm]`` (itself a ``_PermGather``, so any order), not an
    ``index_add``."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(perm, inv_perm)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        perm, inv_perm = ctx.saved_tensors
        return _PermGather.apply(g, inv_perm, perm), None, None


def _perm_gather(x: Tensor, perm: Tensor, inv_perm: Tensor) -> Tensor:
    """``x[perm]`` along dim 0 for a permutation ``perm`` with inverse
    ``inv_perm``, its adjoint a gather through ``inv_perm``."""
    return _PermGather.apply(x, perm, inv_perm)
