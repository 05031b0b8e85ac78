"""What the models' MD paths share.

* :func:`with_forces`: a model's energy and forces = -dE/dpositions by
  autograd, inside the ``nnpops.force`` span (its backward in
  ``nnpops.force.backward``); ANI, SchNet and PaiNN take their forces
  through it.
* :func:`species_of`: one system's species ids from its atomic numbers.
* :class:`CellListPath`: the cell-list MD entry points of a model built
  for one system (``species``, ``config.cutoff``): ``create_cell_list``,
  ``select`` (``CellList.select(build_mirror=True)``), ``overflow_counts``
  and ``capacities``, the entry points of ``ANIModel`` that
  ``md.integrators.run_md_sticky_counts`` drives. SchNet and PaiNN mix it
  in.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..neighbors.cell_list import CellList, SlotSelection
from ..ops.aev_blocked import upload
from ..utils.profiling import span

Tensor = torch.Tensor


def with_forces(energy_fn, positions: Tensor) -> Tuple[Tensor, Tensor]:
    """(energy, -d energy / d positions) of ``energy_fn(positions)``."""
    with span('force'), torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        e = energy_fn(pos)
        with span('force.backward'):
            (grad,) = torch.autograd.grad(e, pos)
        return e.detach(), -grad


def species_of(atomic_numbers, elements) -> Tuple[Tuple[int, ...], int]:
    """(species ``elements.index(z)`` of each atomic number, the number of
    elements); raises on an atomic number not among the elements."""
    table = {int(z): k for k, z in enumerate(elements)}
    missing = sorted({int(z) for z in atomic_numbers} - set(table))
    if missing:
        raise ValueError(f'atomic numbers {missing} are not among the '
                         f'elements {list(elements)}')
    return tuple(table[int(z)] for z in atomic_numbers), len(table)


class CellListPath:
    """The cell list's MD entry points of a model with ``species`` (one
    system's species ids) and ``config.cutoff``."""

    @functools.cached_property
    def _on_device(self) -> dict:
        """The species ids by device, uploaded once (a cache keyed on the
        model would hash its N-element ``species`` on every lookup)."""
        return {}

    def _species_on(self, device: torch.device) -> Tensor:
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = upload(self.species, torch.int64,
                                             device)
        return self._on_device[device]

    def create_cell_list(self, box, skin: float = 0.0) -> CellList:
        """The cell list of the selection: cutoff + ``skin`` (a Verlet skin;
        reselect before an atom moves ``skin / 2``), sized by
        ``CellList.for_density``."""
        return CellList.for_density(box, len(self.species),
                                    self.config.cutoff + skin)

    def select(self, positions: Tensor, box: Tensor,
               cell_list: CellList) -> SlotSelection:
        """Freeze a neighbor selection (every pair inside the cell list's
        cutoff + skin, with the mirror the scatter-free payloads' adjoints
        need) for sticky stepping."""
        with span('select'):
            return cell_list.select(positions, box, build_mirror=True)

    def overflow_counts(self, positions: Tensor, box: Tensor,
                        cell_list: CellList, sel: SlotSelection) -> dict:
        """The true counts of the selection ``sel``'s capacities: neighbors
        inside cutoff + skin of one atom, atoms in one cell."""
        with span('counts'):
            return {'max_neighbors': sel.max_neighbors,
                    'max_cell_occupancy': sel.max_cell_occupancy}

    @staticmethod
    def capacities(cell_list: CellList) -> dict:
        """The capacity each overflow count is held against."""
        return {'max_neighbors': cell_list.capacity,
                'max_cell_occupancy': cell_list.cell_capacity}
