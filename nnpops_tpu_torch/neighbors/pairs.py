"""Fixed-capacity neighbor-pair enumeration, the ``getNeighborPairs`` op
(port of ``nnpops_tpu.neighbors.pairs``).

Semantics of the reference op (``src/pytorch/neighbors/getNeighborPairs.py``):

* all-pairs mode (``max_num_pairs == -1``): every unordered pair is returned;
  pairs beyond the cutoff get index -1 and NaN deltas/distances.
* capacity mode (``max_num_pairs > 0``): pairs within the cutoff are compacted
  to the front, padded with -1/NaN; ``num_pairs`` reports the TRUE number
  found, which may exceed the capacity (getNeighborPairs.py:77-83).

The pair order is the JAX package's: the strictly-lower-triangular
enumeration (row-major), compacted by a stable sort on the validity mask,
so results compare without sorting. NaN padding exists only at this API
boundary; internal consumers (PME direct space) take ``MaskedPairs``, whose
padding is finite so that autograd stays NaN-free.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geometry import minimum_image, validate_box

Tensor = torch.Tensor


def _validate_box(box_vectors, cutoff: float) -> None:
    """The reference's reduced-form / half-box preconditions
    (getNeighborPairsCPU.cpp:40-48); an empty box means no box."""
    if box_vectors is None or not box_vectors.numel():
        return
    validate_box(box_vectors, cutoff)


def _has_box(box_vectors) -> bool:
    return box_vectors is not None and bool(box_vectors.numel())


def _triangular_pairs(num_atoms: int, device) -> Tuple[Tensor, Tensor]:
    """Closed-form (row, col) decode of the flat triangular pair index
    (getNeighborPairsCPU.cpp:58-61): row r is the largest integer with
    r(r-1)/2 <= p, col = p - r(r-1)/2. A float64 sqrt plus an exact integer
    correction in each direction, in int64."""
    num_pairs = num_atoms * (num_atoms - 1) // 2
    idx = torch.arange(num_pairs, dtype=torch.int64, device=device)
    rows = torch.floor((torch.sqrt(8.0 * idx.double() + 1.0) + 1.0) / 2.0).long()
    rows = rows - (rows * (rows - 1) > 2 * idx).long()
    rows = rows + ((rows + 1) * rows <= 2 * idx).long()
    cols = idx - rows * (rows - 1) // 2
    return rows, cols


def _pair_deltas(positions: Tensor, box_vectors):
    rows, cols = _triangular_pairs(positions.shape[0], positions.device)
    deltas = positions[rows] - positions[cols]
    if _has_box(box_vectors):
        deltas = minimum_image(deltas, box_vectors)
    return rows, cols, deltas


class NeighborPairs(NamedTuple):
    """Result of :func:`get_neighbor_pairs` (the reference op's outputs)."""
    neighbors: Tensor   # int32 [2, P]; -1 marks padding
    deltas: Tensor      # float [P, 3]; NaN marks padding
    distances: Tensor   # float [P]; NaN marks padding
    num_pairs: Tensor   # int32 [1]; TRUE number of pairs found


def get_neighbor_pairs(positions: Tensor, cutoff: float,
                       max_num_pairs: int = -1,
                       box_vectors: Optional[Tensor] = None,
                       check_errors: bool = False) -> NeighborPairs:
    """Indices, deltas and distances of atom pairs within ``cutoff``.

    ``deltas[p] = positions[neighbors[0, p]] - positions[neighbors[1, p]]``,
    minimum-imaged when ``box_vectors`` is given. ``check_errors=True``
    reads the pair count on the host and raises RuntimeError on overflow
    (it synchronises, as the reference's check does,
    getNeighborPairsCUDA.cu:156-160)."""
    _validate_box(box_vectors, cutoff)
    cutoff = float(cutoff)
    max_num_pairs = int(max_num_pairs)
    rows, cols, deltas = _pair_deltas(positions, box_vectors)
    distances = torch.sqrt(torch.sum(deltas * deltas, -1))
    within = distances <= cutoff
    nan = float('nan')
    if max_num_pairs == -1:
        neighbors = torch.where(within[None], torch.stack([rows, cols]), -1)
        count = torch.full((1,), distances.shape[0], dtype=torch.int32,
                           device=positions.device)
        result = NeighborPairs(
            neighbors.to(torch.int32),
            torch.where(within[:, None], deltas, nan),
            torch.where(within, distances, nan), count)
    else:
        # Stable compaction of the valid pairs to the front, truncated or
        # padded to the capacity (deterministic, unlike the CUDA reference's
        # atomic append, getNeighborPairsCUDA.cu:68-70).
        order = torch.argsort((~within).to(torch.uint8), stable=True)
        num_found = torch.sum(within.to(torch.int32))
        cap = max_num_pairs
        take = order[:cap]
        if cap > take.shape[0]:
            take = torch.cat([take, take.new_zeros(cap - take.shape[0])])
        slot_valid = torch.arange(cap, device=positions.device) < num_found
        neighbors = torch.where(slot_valid[None],
                                torch.stack([rows[take], cols[take]]), -1)
        result = NeighborPairs(
            neighbors.to(torch.int32),
            torch.where(slot_valid[:, None], deltas[take], nan),
            torch.where(slot_valid, distances[take], nan),
            num_found.reshape(1).to(torch.int32))
    if check_errors and max_num_pairs > 0:
        found = int(result.num_pairs[0])
        if found > max_num_pairs:
            raise RuntimeError(
                'The maximum number of pairs has been exceeded! '
                f'Found {found} but max_num_pairs={max_num_pairs}')
    return result


class MaskedPairs(NamedTuple):
    """Grad-safe padded pair list for internal consumers (PME direct):
    padding carries index 0/0, zero deltas and distance 0 under a False
    mask instead of NaN."""
    atom1: Tensor      # int64 [P]
    atom2: Tensor      # int64 [P]
    deltas: Tensor     # [P, 3] (atom1 <- atom2 direction, minimum-imaged)
    distances: Tensor  # [P]
    mask: Tensor       # bool [P]
    num_pairs: Tensor  # int32 [] true count


def neighbor_pairs_masked(positions: Tensor, cutoff: float,
                          max_num_pairs: int = -1,
                          box_vectors: Optional[Tensor] = None) -> MaskedPairs:
    """All-pairs (or capacity-compacted) masked pair list without NaNs."""
    _validate_box(box_vectors, cutoff)
    cutoff = float(cutoff)
    rows, cols, deltas = _pair_deltas(positions, box_vectors)
    d2 = torch.sum(deltas * deltas, -1)
    within = d2 <= cutoff * cutoff
    num_found = torch.sum(within.to(torch.int32))
    if max_num_pairs != -1 and max_num_pairs < rows.shape[0]:
        order = torch.argsort((~within).to(torch.uint8),
                              stable=True)[:max_num_pairs]
        rows, cols, deltas, d2 = rows[order], cols[order], deltas[order], d2[order]
        within = torch.arange(max_num_pairs, device=positions.device) < num_found
    safe_d2 = torch.where(within, d2, 1.0)
    distances = torch.where(within, torch.sqrt(safe_d2), 0.0)
    return MaskedPairs(torch.where(within, rows, 0), torch.where(within, cols, 0),
                       torch.where(within[:, None], deltas, 0.0), distances,
                       within, num_found)
