"""Species-pure cluster decomposition for the cluster-pair radial kernel
(port of ``nnpops_tpu.neighbors.clusters``).

Atoms are packed into clusters of ``cl`` (= 8) atoms per species by a
quantile-column sort: equal-count x-rank slabs, equal-count y-rank columns
within each slab, z-sorted within each column, chunked into clusters. Every
column's atom count is a static integer (from the species count and the
grid alone), so cluster membership never overflows, and the sorted-rank to
slot map is a static vector. Each i-cluster carries a compacted list of
j-clusters, in two stages: a cluster-level box-box test (its candidates
compacted to ``cand_caps``), then the exact minimum atom-pair distance
over the candidates (compacted to ``jcaps``). The lists are
j-species-major, and the i-cluster itself is the first entry of its own
species' block, so the radial kernel (``ops.cuda_cluster``) finds the self
pair at a static lane.

Capacity contract (soft failures, all observable in ``ClusterSelection``):
the per-(i, j)-species j-cluster counts (``max_jcount`` vs ``plan.jcaps``),
the stage-1 candidate counts (``max_cand`` vs ``plan.cand_caps``), the
entries that reference one j-cluster (``max_mir`` vs ``plan.kmir``) and
the single-image geometric bound (``geom_violation``: one image shift
serves all cl^2 atom pairs of a cluster pair only while 2 max_half_extent
+ reach < box/2 per axis).

The planner needs an orthorhombic-leaning box comfortably larger than
2 (2 cluster_extent + cutoff) and returns None otherwise (the window
radial stays the default).

Port notes:

* :func:`plan_clusters` is numpy f64, as in the JAX package, and its plan
  equals the JAX plan field by field. Its exact-distance stage evaluates
  only the cluster pairs that pass the box-box test (the JAX planner
  evaluates whole 128 x 512 tiles of cluster pairs and keeps the same
  pairs): the same f64 operations on the same pairs, so the same counts.
* The JAX selection also builds ``mirror``/``mirror_mask``, the frozen
  mirror list of the j-gather's custom VJP (``_gather_j``): XLA's
  scatter-add is slow on the TPU. The port gathers with ``index_select``
  and autograd's ``index_add`` is the adjoint, so it keeps no mirror. It
  still computes ``max_mir``, the count the mirror's capacity ``kmir`` is
  held against (the largest number of entries that reference one
  j-cluster), equal to the JAX count.
* JAX's ``.at[idx].set(..., mode='drop')`` drops writes to a sentinel row;
  the port allocates the sentinel rows and slices them off.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import box_transform
from ..ops.cuda_cluster import cluster_radial, cluster_radial_plain
from ..ops.cuda_window import FAR

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Static cluster-mode plan (host-side, hashable)."""
    present: Tuple[int, ...]                 # species ids
    n_sp: Tuple[int, ...]                    # atoms per present species
    cl: int                                  # atoms per cluster
    col_grid: Tuple[Tuple[int, int], ...]    # (ncx, ncy) per species
    ncl: Tuple[int, ...]                     # clusters per species (padded)
    jcaps: Tuple[Tuple[int, ...], ...]       # [I][J] j-cluster capacities
    cand_caps: Tuple[Tuple[int, ...], ...]   # [I][J] stage-1 box-test caps
    kmir: int                                # entries per j-cluster capacity
    reach: float                             # cutoff + skin the plan holds

    @property
    def gid_base(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in np.cumsum((0,) + self.ncl)[:-1])

    @property
    def ncl_total(self) -> int:
        return int(sum(self.ncl))

    @property
    def slot_base(self) -> Tuple[int, ...]:
        return tuple(int(x) * self.cl
                     for x in np.cumsum((0,) + self.ncl)[:-1])

    @property
    def n_slots(self) -> int:
        return self.ncl_total * self.cl

    @property
    def ktot(self) -> Tuple[int, ...]:
        return tuple(int(sum(j)) for j in self.jcaps)

    @property
    def n_entries(self) -> int:
        return int(sum(self.ncl[i] * self.ktot[i]
                       for i in range(len(self.ncl))))


class ClusterSelection(NamedTuple):
    """Frozen cluster selection (refresh-scoped)."""
    wrap_shift: Tensor           # [N, 3] frozen box wrap per atom
    slot_of_atom: Tensor         # [N] global slot id
    jlists: Tuple[Tensor, ...]   # per I: [ncl_I, ktot_I] global j-cluster ids
    jmasks: Tuple[Tensor, ...]   # per I: [ncl_I, ktot_I]
    shifts: Tuple[Tensor, ...]   # per I: [3, ncl_I, ktot_I] image shifts
    max_jcount: Tensor           # [S, S] true max j-cluster counts
    max_cand: Tensor             # [S, S] true max stage-1 box-test counts
    max_mir: Tensor              # scalar: most entries on one j-cluster
    geom_violation: Tensor       # bool: a cluster pair could wrap twice

    def did_overflow(self, plan: ClusterPlan) -> Tensor:
        dev = self.max_jcount.device
        jc = torch.any(self.max_jcount > torch.tensor(plan.jcaps, device=dev))
        # Stage-1 truncation drops candidates before the exact stage, which
        # max_jcount cannot see: hold the candidate counts to cand_caps too.
        cand = torch.any(self.max_cand > torch.tensor(plan.cand_caps,
                                                      device=dev))
        return jc | cand | (self.max_mir > plan.kmir) | self.geom_violation


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


@functools.lru_cache(maxsize=64)
def _column_layout(n_s: int, ncx: int, ncy: int, cl: int):
    """Static rank-space layout of equal-count quantile columns: (the
    x-slab of each x-rank, the column of each (slab, y)-sorted rank, the
    cluster slot of each (column, z)-sorted rank, the species' slot count;
    clusters per column ``ceil(count / cl)``, the last one padded)."""
    slab_bounds = np.array([s * n_s // ncx for s in range(ncx + 1)])
    slab_of_xrank = np.repeat(np.arange(ncx, dtype=np.int32),
                              np.diff(slab_bounds))
    col_of_r2 = np.empty(n_s, np.int32)
    cnt = []
    cid = 0
    for s in range(ncx):
        m = int(slab_bounds[s + 1] - slab_bounds[s])
        for k in range(ncy):
            a0 = int(slab_bounds[s]) + k * m // ncy
            a1 = int(slab_bounds[s]) + (k + 1) * m // ncy
            col_of_r2[a0:a1] = cid
            cnt.append(a1 - a0)
            cid += 1
    cnt = np.asarray(cnt)
    nclus = -(-cnt // cl)
    slot_base = np.concatenate([[0], np.cumsum(nclus * cl)])
    col_start = np.concatenate([[0], np.cumsum(cnt)])
    slot_of_r3 = (np.arange(n_s)
                  + (slot_base[:-1] - col_start[:-1])[col_of_r2])
    return (slab_of_xrank, col_of_r2, slot_of_r3.astype(np.int32),
            int(slot_base[-1]))


def _pack_species_np(frac_s: np.ndarray, ncx: int, ncy: int, cl: int):
    """Planner-side packing: (order [n_s] into the species block,
    slot_of_ordered [n_s], n_slots)."""
    n_s = len(frac_s)
    slab_of_xrank, col_of_r2, slot_of_r3, n_slots = _column_layout(
        n_s, ncx, ncy, cl)
    o1 = np.argsort(frac_s[:, 0], kind='stable')
    key2 = slab_of_xrank * 2.0 + frac_s[o1, 1]
    o2 = o1[np.argsort(key2, kind='stable')]
    key3 = col_of_r2 * 2.0 + frac_s[o2, 2]
    o3 = o2[np.argsort(key3, kind='stable')]
    return o3, slot_of_r3, n_slots


def _cluster_geometry_np(q: np.ndarray, slots: np.ndarray, n_slots: int,
                         cl: int):
    """Centroids, half-extents and validity per cluster (numpy)."""
    ncl_s = n_slots // cl
    qs = np.full((n_slots, 3), FAR)
    qs[slots] = q
    tiles = qs.reshape(ncl_s, cl, 3)
    vmask = tiles[:, :, 0] < FAR * 0.5
    lo = np.where(vmask[..., None], tiles, FAR).min(1)
    hi = np.where(vmask[..., None], tiles, -FAR).max(1)
    valid = vmask.any(1)
    cent = np.where(valid[:, None], (lo + hi) / 2, FAR)
    half = np.where(valid[:, None], (hi - lo) / 2, 0.0)
    return cent, half, valid


def _exact_pairs(ok: np.ndarray, ti: np.ndarray, tj: np.ndarray,
                 diag: np.ndarray, reach: float,
                 chunk: int = 16384) -> np.ndarray:
    """``ok`` narrowed to the cluster pairs whose minimum atom-pair
    distance (minimum image per coordinate) is below ``reach``."""
    ii, jj = np.nonzero(ok)
    exact = np.zeros_like(ok)
    for p0 in range(0, len(ii), chunk):
        a, b = ii[p0:p0 + chunk], jj[p0:p0 + chunk]
        d = ti[a][:, :, None, :] - tj[b][:, None, :, :]      # [P, cl, cl, 3]
        d -= np.round(d / diag) * diag
        mind2 = (d ** 2).sum(-1).min((1, 2))
        exact[a, b] = mind2 < reach * reach
    return exact


# Cluster counts per species are rounded up to a multiple of this, as the
# JAX planner rounds them for its kernel's grid (8 i-clusters a step), so
# that the plans are equal.
NCL_MULTIPLE = 8


def plan_clusters(positions, box, species, cutoff: float, skin: float = 0.0,
                  margin: float = 1.15, cl: int = 8) -> Optional[ClusterPlan]:
    """Host-side planner: cluster layout and capacities from this
    configuration (observed maxima times ``margin``, as the window
    planner). Returns None when the box is unsuitable (strongly triclinic,
    or too small for the single-image shift bound)."""
    box_np = np.asarray(box, np.float64) if box is not None else None
    if box_np is None or box_np.shape != (3, 3):
        return None
    diag = np.diag(box_np)
    off = np.abs(box_np - np.diag(diag)).max()
    if off > 0.05 * diag.min() or (diag < 2 * (cutoff + skin)).any():
        return None
    reach = float(cutoff + skin)
    positions = np.asarray(positions, np.float64)
    species = np.asarray(species)
    present = tuple(int(s) for s in np.unique(species))
    frac = positions @ np.linalg.inv(box_np)
    frac -= np.floor(frac)
    pos_w = frac @ box_np
    vol = float(abs(np.linalg.det(box_np)))

    n_sp, col_grid, ncl = [], [], []
    cents, halves, valids, tiles_sp = [], [], [], []
    for s in present:
        idx = np.where(species == s)[0]
        n_s = len(idx)
        side = (cl / max(n_s / vol, 1e-12)) ** (1.0 / 3.0)
        ncx = max(1, int(round(diag[0] / side)))
        ncy = max(1, int(round(diag[1] / side)))
        order, slots, n_slots = _pack_species_np(frac[idx], ncx, ncy, cl)
        ncl_s = _round_up(n_slots // cl, NCL_MULTIPLE)
        cent, half, valid = _cluster_geometry_np(
            pos_w[idx[order]], slots, ncl_s * cl, cl)
        qs = np.full((ncl_s * cl, 3), FAR)
        qs[slots] = pos_w[idx[order]]
        tiles_sp.append(qs.reshape(ncl_s, cl, 3))
        n_sp.append(n_s)
        col_grid.append((ncx, ncy))
        ncl.append(ncl_s)
        cents.append(cent)
        halves.append(half)
        valids.append(valid)

    # One image shift serves all cl^2 atom pairs of a cluster pair only
    # while 2 max_half + reach < box/2 per axis; enforced here with drift
    # headroom and checked again at every selection (geom_violation).
    max_half = np.max([h.max(0) for h in halves], axis=0)
    if ((2 * max_half * 1.2 + reach) >= diag / 2).any():
        return None

    # Stage 1 is the cluster-level box-box test, stage 2 the exact minimum
    # atom-pair distance over its candidates (the box hull over-includes,
    # so caps from exact counts keep the kernel's lanes tighter).
    jcaps, cand_caps = [], []
    occur = [np.zeros(n, np.int64) for n in ncl]
    for i in range(len(present)):
        caps_i, ccaps_i = [], []
        for j in range(len(present)):
            dc = cents[j][None, :, :] - cents[i][:, None, :]
            dc -= np.round(dc / diag) * diag
            gap = np.maximum(np.abs(dc)
                             - (halves[i][:, None, :] + halves[j][None]),
                             0.0)
            ok = (((gap ** 2).sum(-1) < reach * reach)
                  & valids[i][:, None] & valids[j][None, :])
            ccaps_i.append(int(np.ceil(ok.sum(1).max() * margin)) + 1)
            exact = _exact_pairs(ok, tiles_sp[i], tiles_sp[j], diag, reach)
            cap = int(np.ceil(exact.sum(1).max() * margin)) + 1
            if i == j:
                cap = max(cap, 2)
            caps_i.append(cap)
            occur[j] += exact.sum(0)
        jcaps.append(caps_i)
        cand_caps.append(ccaps_i)
    # Every per-(i, j) lane block is rounded to 128 lanes (jcap * cl), as
    # the JAX planner rounds it for the TPU's lane slices; kept so the
    # plans are equal.
    mult = max(1, 128 // cl)
    for i in range(len(present)):
        jcaps[i] = [_round_up(c, mult) for c in jcaps[i]]
        # Stage 2's lanes must never exceed what stage 1 can supply.
        cand_caps[i] = [max(cc, jc) for cc, jc in zip(cand_caps[i],
                                                      jcaps[i])]
    kmir = int(np.ceil(max(int(o.max()) for o in occur) * margin)) + 1
    return ClusterPlan(present=present, n_sp=tuple(n_sp), cl=cl,
                       col_grid=tuple(col_grid),
                       ncl=tuple(int(x) for x in ncl),
                       jcaps=tuple(tuple(int(c) for c in j) for j in jcaps),
                       cand_caps=tuple(tuple(int(c) for c in j)
                                       for j in cand_caps),
                       kmir=kmir, reach=reach)


@functools.lru_cache(maxsize=16)
def _species_tables(plan: ClusterPlan, species: Tuple[int, ...],
                    device: torch.device):
    """Per present species (atom ids, x-slab of each x-rank, column of each
    (slab, y) rank, global slot of each (column, z) rank) on ``device``."""
    species = np.asarray(species, np.int32)
    out = []
    for i, s in enumerate(plan.present):
        idx = np.where(species == s)[0]
        if len(idx) != plan.n_sp[i]:
            raise ValueError('species counts do not match the cluster plan')
        ncx, ncy = plan.col_grid[i]
        slab, col, slot, _ = _column_layout(plan.n_sp[i], ncx, ncy, plan.cl)
        out.append(tuple(torch.as_tensor(a, device=device) for a in (
            idx.astype(np.int64), slab.astype(np.float32),
            col.astype(np.float32),
            slot.astype(np.int64) + plan.slot_base[i])))
    return tuple(out)


def _sum3(v: Tensor) -> Tensor:
    """Sum over the last axis of size 3, in a fixed order."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def _min_image_shift(delta: Tensor, box: Tensor) -> Tensor:
    """The image shift to subtract from the j side (min-imaged delta =
    delta - shift), rounded in the order of the window path's
    ``_part_deltas``."""
    dy = delta[..., 1]
    dz = delta[..., 2]
    s3 = torch.round(dz / box[2, 2])
    dy = dy - s3 * box[2, 1]
    s2 = torch.round(dy / box[1, 1])
    dx = delta[..., 0] - s3 * box[2, 0] - s2 * box[1, 0]
    s1 = torch.round(dx / box[0, 0])
    return (s3[..., None] * box[2] + s2[..., None] * box[1]
            + s1[..., None] * box[0])


def _take_rows(table: Tensor, index: Tensor) -> Tensor:
    """``table[index]`` along dim 0 for any index shape, by index_select."""
    return table.index_select(0, index.reshape(-1)).reshape(
        index.shape + table.shape[1:])


@torch.no_grad()
def select_clusters(positions: Tensor, box: Tensor, species,
                    plan: ClusterPlan, cutoff: float,
                    skin: float = 0.0) -> ClusterSelection:
    """Freeze a cluster selection: quantile-column slot assignment, the
    two-stage j-lists and the per-entry image shifts. ``cutoff + skin``
    must be what ``plan_clusters`` sized the plan for (the plan's reach is
    used). ``species``: host ids, or a tensor of them (copied to the
    host)."""
    del cutoff, skin
    positions = positions.detach()
    box = box.detach()
    dev = positions.device
    n = positions.shape[0]
    cl = plan.cl
    npres = len(plan.present)
    reach = plan.reach
    frac = box_transform(positions, torch.linalg.inv(box))
    wrap_f = torch.floor(frac)
    wrap_shift = box_transform(wrap_f, box)
    p_w = positions - wrap_shift
    frac_in = frac - wrap_f

    n_slots = plan.n_slots
    slot_of_atom = torch.full((n,), n_slots, dtype=torch.int64, device=dev)
    ids = (species.tolist() if isinstance(species, Tensor)
           else [int(s) for s in species])
    tables = _species_tables(plan, tuple(ids), dev)
    for idx, slab, col, gslot in tables:
        # Stable sorts by f32 keys, as lax.sort of (key, payload).
        o1 = idx[torch.sort(frac_in[idx, 0], stable=True).indices]
        key2 = slab * 2.0 + frac_in[o1, 1]
        o2 = o1[torch.sort(key2, stable=True).indices]
        key3 = col * 2.0 + frac_in[o2, 2]
        o3 = o2[torch.sort(key3, stable=True).indices]
        slot_of_atom.index_copy_(0, o3, gslot)

    # Cluster tiles at the selection's positions -> centroids, extents.
    planes = positions.new_full((n_slots + 1, 3), FAR).index_copy(
        0, slot_of_atom, p_w)
    tiles = planes[:n_slots].reshape(plan.ncl_total, cl, 3)
    valid_slot = tiles[:, :, 0] < FAR * 0.5                    # [ncl, cl]
    big = torch.tensor(FAR, dtype=positions.dtype, device=dev)
    lo = torch.where(valid_slot[..., None], tiles, big).amin(1)
    hi = torch.where(valid_slot[..., None], tiles, -big).amax(1)
    cvalid = valid_slot.any(1)
    cent = torch.where(cvalid[:, None], (lo + hi) * 0.5, big)
    half = torch.where(cvalid[:, None], (hi - lo) * 0.5, 0.0)
    diag3 = torch.stack([box[0, 0], box[1, 1], box[2, 2]])
    geom_violation = torch.any(2.0 * half.amax(0) + reach >= diag3 / 2)

    gid_base = plan.gid_base
    centp = torch.cat([cent, cent.new_full((1, 3), FAR)])
    tiles_pad = torch.cat([tiles, tiles.new_full((1, cl, 3), FAR)])
    jlists, jmasks, shifts = [], [], []
    max_jcount = torch.zeros(npres, npres, dtype=torch.int64, device=dev)
    max_cand = torch.zeros(npres, npres, dtype=torch.int64, device=dev)
    for i in range(npres):
        si = slice(gid_base[i], gid_base[i] + plan.ncl[i])
        ci, hi_i, vi, ti = cent[si], half[si], cvalid[si], tiles[si]
        blocks, bmasks = [], []
        for j in range(npres):
            sj = slice(gid_base[j], gid_base[j] + plan.ncl[j])
            dc = cent[sj][None, :, :] - ci[:, None, :]
            dc = dc - torch.round(dc / diag3) * diag3
            gap = torch.clamp(dc.abs() - (hi_i[:, None, :] + half[sj][None]),
                              min=0.0)
            ok = (_sum3(gap * gap) < reach * reach) & vi[:, None] \
                & cvalid[sj][None, :]
            if i == j:
                ok &= ~torch.eye(plan.ncl[i], dtype=torch.bool, device=dev)
            # Stage 1: the box-test passes compacted to cand_caps; the count
            # is taken before the truncation.
            max_cand[i, j] = ok.sum(1).max()
            bigk = plan.ncl[j]
            lid = torch.arange(plan.ncl[j], device=dev)
            top1 = torch.sort(torch.where(ok, lid[None, :], bigk),
                              dim=1).values[:, :plan.cand_caps[i][j]]
            m1 = top1 < bigk
            gid1 = torch.where(m1, top1 + gid_base[j], plan.ncl_total)
            # Stage 2: the exact minimum atom-pair distance.
            sh1 = _min_image_shift(_take_rows(centp, gid1) - ci[:, None, :],
                                   box)
            tjs = _take_rows(tiles_pad, gid1) - sh1[:, :, None, :]
            d = ti[:, None, :, None, :] - tjs[:, :, None, :, :]
            mind2 = _sum3(d * d).amin((2, 3))
            exact = m1 & (mind2 < reach * reach)
            max_jcount[i, j] = exact.sum(1).max() + (1 if i == j else 0)
            cap = plan.jcaps[i][j] - (1 if i == j else 0)
            big2 = plan.ncl[j] + 1
            top = torch.sort(torch.where(exact, top1, big2),
                             dim=1).values[:, :cap]
            if top.shape[1] < cap:
                # jcap can exceed the candidate columns: pad every block to
                # exactly cap entries.
                top = torch.cat([top, top.new_full(
                    (top.shape[0], cap - top.shape[1]), big2)], 1)
            m = top < big2
            blk = torch.where(m, top, plan.ncl_total - gid_base[j]) \
                + gid_base[j]
            if i == j:
                self_ids = torch.arange(plan.ncl[i], device=dev) + gid_base[i]
                blk = torch.cat([self_ids[:, None], blk], 1)
                m = torch.cat([torch.ones(plan.ncl[i], 1, dtype=torch.bool,
                                          device=dev), m], 1)
            blocks.append(blk)
            bmasks.append(m)
        jl = torch.cat(blocks, 1)                     # [ncl_i, ktot_i]
        jm = torch.cat(bmasks, 1)
        # One image shift per entry from the centroid delta (exact for all
        # cl^2 atom pairs under the geometric bound); 0 on masked entries,
        # so padding lanes stay at FAR.
        sh = _min_image_shift(
            _take_rows(centp, torch.clamp(jl, max=plan.ncl_total))
            - ci[:, None, :], box)
        sh = torch.where(jm[..., None], sh, 0.0)
        jlists.append(jl)
        jmasks.append(jm)
        shifts.append(sh.permute(2, 0, 1))            # [3, ncl_i, ktot_i]

    # The most forward entries that reference one j-cluster.
    jg = torch.cat([jl.reshape(-1) for jl in jlists])
    valid = torch.cat([jm.reshape(-1) for jm in jmasks])
    refs = torch.zeros(plan.ncl_total + 1, dtype=torch.int64, device=dev)
    refs.index_add_(0, torch.where(valid, jg, plan.ncl_total), valid.long())
    max_mir = refs[:plan.ncl_total].max()
    return ClusterSelection(
        wrap_shift=wrap_shift, slot_of_atom=slot_of_atom,
        jlists=tuple(jlists), jmasks=tuple(jmasks), shifts=tuple(shifts),
        max_jcount=max_jcount, max_cand=max_cand, max_mir=max_mir,
        geom_violation=geom_violation)


def cluster_radial_features(positions: Tensor, sel: ClusterSelection,
                            plan: ClusterPlan, basis, row_atom: Tensor,
                            plain: bool = False) -> Tensor:
    """Per-atom radial AEV rows ``[len(row_atom), P*R]`` through the
    cluster-pair kernel, differentiable in ``positions`` (``row_atom``: the
    atom of each output row; column ``p*R + q`` is radial function q
    against present species p, the window radial's layout). The j-cluster
    gather is an ``index_select``, its adjoint autograd's ``index_add``.
    ``plain`` runs the kernel's plain version on any device."""
    cl = plan.cl
    n_slots = plan.n_slots
    p_w = positions - sel.wrap_shift
    planes = p_w.new_full((n_slots + 1, 3), FAR).index_copy(
        0, sel.slot_of_atom, p_w)
    tiles = planes[:n_slots].reshape(plan.ncl_total, cl, 3)
    tiles_pad = torch.cat([tiles, tiles.new_full((1, cl, 3), FAR)])
    jidx = torch.cat([torch.clamp(jl, max=plan.ncl_total).reshape(-1)
                      for jl in sel.jlists])
    shifts = torch.cat([sh.permute(1, 2, 0).reshape(-1, 3)
                        for sh in sel.shifts])
    jt = tiles_pad.index_select(0, jidx) - shifts[:, None, :]  # [E, cl, 3]
    radial_fn = cluster_radial_plain if plain else cluster_radial
    out_blocks = []
    off = 0
    for i in range(len(plan.present)):
        ncl_i, ktot_i = plan.ncl[i], plan.ktot[i]
        lanes = jt[off:off + ncl_i * ktot_i].reshape(
            ncl_i, ktot_i * cl, 3).permute(2, 0, 1).contiguous()
        off += ncl_i * ktot_i
        centers = tiles[plan.gid_base[i]:plan.gid_base[i] + ncl_i]
        out_blocks.append(radial_fn(
            lanes[0], lanes[1], lanes[2], centers, basis.radial_cutoff,
            basis.radial_eta, basis.radial_rs, cl, plan.jcaps[i], i,
            basis.torchani))                                 # [ncl_i, cl, P*R]
    rad_slots = torch.cat(out_blocks, 0).reshape(n_slots, -1)
    row_slots = torch.clamp(sel.slot_of_atom[row_atom], max=n_slots - 1)
    return rad_slots.index_select(0, row_slots)
