"""Static cell decomposition (port of ``nnpops_tpu.neighbors.cell_list``).

This slice ports what the species-blocked selection needs: the cell grid
sized from the box's perpendicular widths, the per-cell capacity, and the
27-cell stencil. ``CellList.build``/``select`` and the payload builders of
the JAX class come with the dense and payload AEV paths (ROADMAP A.6).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..geometry import validate_box


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
