"""AEV over species-blocked neighbor lists (port of
``nnpops_tpu.ops.aev_blocked``).

The payload's lanes are grouped by species with static capacities, so the
radial per-species scatter is a static slice sum, and the angular triples
enumerate species-pair blocks in species-pair-major order, so the
per-species-pair scatter is a static slice sum too. Only species pairs
present in the system are computed (a water box runs 3 of ANI-2x's 28 pair
channels; the rest are exact zeros).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ANIBasis
from ..geometry import cosine_cutoff
from ..neighbors.blocked import BlockedLayout, BlockedPayload
from ..utils.profiling import COUNTERS
from .aev import AEV, species_pair_index


class TripleTables(NamedTuple):
    """Static triple enumeration for a BlockedLayout (host-built)."""
    jj: np.ndarray            # [T] first-lane index into the angular list
    kk: np.ndarray            # [T] second-lane index
    seg_bounds: Tuple[int, ...]   # len n_pairs+1, segment t-ranges
    pair_ids: Tuple[int, ...]     # len n_pairs, unordered species-pair index


def build_triple_tables(layout: BlockedLayout) -> TripleTables:
    """Enumerate angular lane pairs species-pair block by block: within a
    species block j < k (each unordered pair once); across blocks (present
    order) the full cross product. Segments are contiguous in t."""
    table = species_pair_index(layout.num_species)
    offs = layout.ang_offsets
    jj, kk, bounds, pair_ids = [], [], [0], []
    for i, si in enumerate(layout.present):
        for j in range(i, len(layout.present)):
            sj = layout.present[j]
            oi, ki = offs[i], layout.ang_caps[i]
            oj, kj = offs[j], layout.ang_caps[j]
            if i == j:
                a, b = np.triu_indices(ki, k=1)
                jj.append(a + oi)
                kk.append(b + oi)
            else:
                a, b = np.meshgrid(np.arange(ki), np.arange(kj),
                                   indexing='ij')
                jj.append(a.reshape(-1) + oi)
                kk.append(b.reshape(-1) + oj)
            bounds.append(bounds[-1] + len(jj[-1]))
            pair_ids.append(int(table[si, sj]))
    return TripleTables(
        jj=np.concatenate(jj).astype(np.int32) if jj else np.zeros(0, np.int32),
        kk=np.concatenate(kk).astype(np.int32) if kk else np.zeros(0, np.int32),
        seg_bounds=tuple(bounds), pair_ids=tuple(pair_ids))


@functools.lru_cache(maxsize=32)
def triple_tables(layout: BlockedLayout) -> TripleTables:
    return build_triple_tables(layout)


def upload(values, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """``values`` (a host array or sequence) as a tensor on ``device``,
    counted in ``utils.profiling.COUNTERS``: every host-to-device copy of
    the window path's selection, force call and counts goes through
    here. The per-atom tables are copied once per model and device
    (``ANIModel._device_arrays``: grouping order, species ids) or once per
    species counts, planned tier rows and device (``concat_pos``), so a
    warm window selection through ``ANIModel.select`` uploads nothing."""
    t = torch.as_tensor(values, dtype=dtype, device=device)
    COUNTERS['uploads'] += 1
    COUNTERS['upload_bytes'] += t.numel() * t.element_size()
    return t


@functools.lru_cache(maxsize=64)
def device_constant(values: Tuple[float, ...], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``values`` on ``device``, uploaded (and counted) on each miss of a
    64-entry cache keyed by the tuple itself, since a copy inside the MD
    step would synchronise the stream. A hit uploads nothing, but the
    caller still builds the tuple and the cache hashes and compares it: a
    host cost that grows with its length. So only short tables come here
    (the window selection through ``ANIModel.select`` asks for none longer
    than ``num_species + 1``); the per-atom ones are made once per model
    and device (``ANIModel._device_arrays``) and handed to
    ``select_window`` as tensors. ``select_window`` still makes a host
    array given in their place into an N-element constant here."""
    return upload(values, dtype, device)


def compute_aev_blocked(payload: BlockedPayload, basis: ANIBasis,
                        layout: BlockedLayout,
                        chunk_size: Optional[int] = None,
                        angular_impl: str = 'plain') -> AEV:
    """Radial + angular AEV from a species-blocked payload, in the reference
    layout (radial [N, S*R], angular [N, P*A]).

    ``chunk_size``: process the rows in blocks of this many to bound the
    [chunk, T, A] angular intermediates at large N ('plain' only: the
    angular kernel needs no chunking).

    ``angular_impl``: 'plain' (the PyTorch angular block, any device) or
    'cuda' (the angular kernel's wrapper, :func:`ops.cuda_aev.angular_aev`).
    A rad-only payload (``ang_deltas`` None) hands the radial planes to the
    angular code, which slices the angular lanes itself.
    """
    from .cuda_aev import angular_aev, angular_aev_plain, place_angular
    if angular_impl not in ('plain', 'cuda'):
        raise ValueError(f"angular_impl={angular_impl!r} not in ('plain', 'cuda')")
    n = payload.rad_r.shape[0]
    if chunk_size is not None and n > chunk_size and angular_impl == 'plain':
        return _chunked(payload, basis, layout, chunk_size)
    deltas = payload.rad_deltas
    dtype, dev = deltas.dtype, deltas.device
    rc = basis.radial_cutoff

    # ---- Radial block: per-pair term, then static per-species slice sums.
    r_eta = device_constant(basis.radial_eta, dtype, dev)
    r_rs = device_constant(basis.radial_rs, dtype, dev)
    mask = payload.rad_mask & (payload.rad_r < rc)
    safe_r = torch.where(mask, payload.rad_r, 1.0)
    fc = cosine_cutoff(safe_r, rc)
    shifted = safe_r[..., None] - r_rs
    radial_pair = fc[..., None] * torch.exp(-r_eta * shifted * shifted)
    radial_pair = torch.where(mask[..., None], radial_pair, 0.0)   # [N, Krt, R]
    zero_col = radial_pair.new_zeros(n, basis.num_radial)
    cols = [zero_col] * basis.num_species
    for i, sp in enumerate(layout.present):
        off = layout.rad_offsets[i]
        cols[sp] = torch.sum(radial_pair[:, off:off + layout.rad_caps[i], :], 1)
    radial = torch.stack(cols, 1)                                  # [N, S, R]
    if basis.torchani:
        radial = radial * 0.25

    # ---- Angular block.
    if payload.ang_deltas is None:
        ang_in, rad_width = payload.rad_deltas, payload.rad_deltas.shape[2]
    else:
        ang_in, rad_width = payload.ang_deltas, None
    if angular_impl == 'cuda':
        angular = angular_aev(ang_in, payload.ang_mask, basis, layout,
                              rad_width=rad_width)
    else:
        angular = place_angular(
            angular_aev_plain(ang_in, payload.ang_mask, basis, layout,
                              rad_width=rad_width), basis, layout)
    return AEV(radial.reshape(n, -1), angular)


def _chunked(payload: BlockedPayload, basis: ANIBasis, layout: BlockedLayout,
             chunk_size: int) -> AEV:
    """:func:`compute_aev_blocked` ('plain') over blocks of rows (the last
    one shorter; no padding is needed outside ``lax.map``)."""
    def rows(x, dim):
        n_blocks = -(-payload.rad_r.shape[0] // chunk_size)
        return ([None] * n_blocks if x is None
                else torch.split(x, chunk_size, dim))

    fields = zip(rows(payload.rad_deltas, 1), rows(payload.rad_r, 0),
                 rows(payload.rad_mask, 0), rows(payload.ang_deltas, 1),
                 rows(payload.ang_r, 0), rows(payload.ang_mask, 0))
    parts = [compute_aev_blocked(payload._replace(
        rad_deltas=rd, rad_r=rr, rad_mask=rm, ang_deltas=ad, ang_r=ar,
        ang_mask=am, ang_in_rad=None), basis, layout)
        for rd, rr, rm, ad, ar, am in fields]
    return AEV(torch.cat([p.radial for p in parts]),
               torch.cat([p.angular for p in parts]))
