"""Combined force field: ANI potential + PME electrostatics (port of
``nnpops_tpu.models.combined``).

The north-star MD configuration (BASELINE config 5) couples the ANI-2x
potential with PME long-range electrostatics:

* the ANI part runs the window pipeline against a frozen selection
  (Verlet-skin stepping, like ``ANIModel`` alone);
* the PME direct term runs the window kernel (``ops.cuda_pme``, B.5) on
  its own cutoff-sized grid, no pair list;
* the PME reciprocal term spreads with one ``index_add`` and transforms
  with ``torch.fft.rfftn`` (``ops.pme``).

Soft-failure contract: ``overflow_counts``/``check_overflow`` join the ANI
capacities with the PME window occupancy and the spread-chunk count (the
``number_found_pairs`` pattern, getNeighborPairs.py:77-83); call between
blocks of steps, on the host.

When no window plan fits the box (or none was planned), the PME direct
term takes the JAX package's pair path: the half pairs of the ANI cell
list's ``build_payload``, re-masked to the PME cutoff (which should not
exceed the cell list's cutoff).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ANIBasis
from ..geometry import validate_box
from ..neighbors.cell_list import CellList, payload_to_half_pairs
from ..ops.batched_nn import resolve_device
from ..ops.pme import (PME, pme_direct_energy, pme_reciprocal_energy,
                       pme_self_energy, spread_capacity, spread_overflow)
from ..utils.profiling import span
from .ani import ANIModel, ANIParams

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ANIWithPME:
    """ANI potential + PME electrostatics on a fixed-topology system.

    Build with :meth:`create`, which plans the PME direct window from a
    reference configuration."""
    ani: ANIModel
    pme: PME
    pme_cutoff: float
    # (ncells3, capacity, small_cap, num_big) from PME.plan_direct_window.
    pme_window_plan: Optional[Tuple] = None

    @classmethod
    def create(cls, ani: ANIModel, pme: PME, pme_cutoff: float,
               positions=None, box=None, margin: float = 1.25) -> 'ANIWithPME':
        """Compose the models; with a reference configuration, plan the PME
        direct window (bucketed 4-tuple plan, on the host, once; the box is
        validated here)."""
        plan = None
        if positions is not None and box is not None:
            validate_box(box, pme_cutoff)
            grid, cap, small, nbig = pme.plan_direct_window(
                box, pme_cutoff, positions, margin=margin, bucket=True)
            if grid is not None:
                plan = (grid, cap, small, nbig)
        return cls(ani=ani, pme=pme, pme_cutoff=pme_cutoff,
                   pme_window_plan=plan)

    # ---- Selection API (Verlet-skin stepping, mirrors ANIModel's).

    def select(self, positions: Tensor, box: Tensor, cell_list):
        return self.ani.select(positions, box, cell_list)

    def _pme_direct(self, positions: Tensor, charges: Tensor, box: Tensor,
                    cell_list: Optional[CellList] = None,
                    plain: bool = False) -> Tensor:
        """The PME direct term: the window kernel (B.5) with a plan, else
        the pair path over ``cell_list``'s payload."""
        if self.pme_window_plan is None:
            if cell_list is None:
                raise ValueError('without a PME window plan the direct term '
                                 'takes its pairs from the cell list: pass '
                                 'cell_list')
            pairs = payload_to_half_pairs(
                cell_list.build_payload(positions, box), self.pme_cutoff)
            cfg = self.pme.config
            return pme_direct_energy(positions, charges, pairs,
                                     self.pme.exclusions, cfg.alpha,
                                     cfg.coulomb)
        return self.pme.compute_direct_window(
            positions, charges, self.pme_cutoff, box, self.pme_window_plan,
            plain=plain)

    def _pme_reciprocal(self, positions: Tensor, charges: Tensor,
                        box: Tensor) -> Tensor:
        """The PME reciprocal and self terms."""
        cfg = self.pme.config
        return (pme_self_energy(charges, cfg.alpha, cfg.coulomb)
                + pme_reciprocal_energy(positions, charges, box, cfg,
                                        self.pme.moduli))

    def _pme_energy(self, positions: Tensor, charges: Tensor, box: Tensor,
                    cell_list, plain: bool = False) -> Tensor:
        return (self._pme_direct(positions, charges, box, cell_list, plain)
                + self._pme_reciprocal(positions, charges, box))

    def _energy(self, params, positions, charges, box, cell_list, sel,
                plain: bool):
        """``plain`` swaps every kernel, ANI's and B.5, for its plain
        PyTorch version (see :func:`plain_energy_and_forces`)."""
        e_ani = self.ani._energy(params, positions, box, cell_list, sel, plain)
        return e_ani + self._pme_energy(positions, charges, box, cell_list,
                                        plain)

    def energy_from_selection(self, params: ANIParams, positions: Tensor,
                              charges: Tensor, box: Tensor, cell_list,
                              sel) -> Tensor:
        """Total energy against a frozen ANI selection: window ANI + window
        PME direct + reciprocal."""
        return self._energy(params, positions, charges, box, cell_list, sel,
                            False)

    def _energy_and_forces(self, params, positions, charges, box, cell_list,
                           sel, plain: bool):
        with span('force'), torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = self._energy(params, pos, charges, box, cell_list, sel, plain)
            with span('force.backward'):
                (grad,) = torch.autograd.grad(e, pos)
            return e.detach(), -grad

    def energy_and_forces_from_selection(
            self, params: ANIParams, positions: Tensor, charges: Tensor,
            box: Tensor, cell_list, sel) -> Tuple[Tensor, Tensor]:
        """Energy and forces = -dE/dpositions against a frozen selection."""
        return self._energy_and_forces(params, positions, charges, box,
                                       cell_list, sel, False)

    # ---- One-shot API (selection built inline; same paths).

    def energy(self, params: ANIParams, positions: Tensor, charges: Tensor,
               box: Tensor, cell_list) -> Tensor:
        e_ani = self.ani.energy_fused(params, positions, box, cell_list)
        return e_ani + self._pme_energy(positions, charges, box, cell_list)

    def energy_and_forces(self, params: ANIParams, positions: Tensor,
                          charges: Tensor, box: Tensor,
                          cell_list) -> Tuple[Tensor, Tensor]:
        with span('force'), torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = self.energy(params, pos, charges, box, cell_list)
            with span('force.backward'):
                (grad,) = torch.autograd.grad(e, pos)
            return e.detach(), -grad

    # ---- Soft-failure contract (getNeighborPairs.py:77-83 pattern).

    def overflow_counts(self, positions: Tensor, charges: Tensor, box: Tensor,
                        cell_list, sel=None) -> dict:
        """TRUE counts for every static capacity, as device tensors: the
        ANI counts plus 'pme_window_occupancy' (vs ``pme_window_plan[1]``)
        and 'pme_spread_chunk' (vs ``spread_capacity``), the JAX package's
        keys."""
        counts = dict(self.ani.overflow_counts(positions, box, cell_list,
                                               sel))
        if self.pme_window_plan is not None:
            counts['pme_window_occupancy'] = self.pme.direct_window_overflow(
                positions, box, self.pme_window_plan)
        counts['pme_spread_chunk'] = spread_overflow(
            positions, charges, box, self.pme.config)
        return counts

    def capacities(self, cell_list) -> dict:
        """The capacity each overflow count is held against."""
        caps = dict(self.ani._capacities(cell_list))
        if self.pme_window_plan is not None:
            caps['pme_window_occupancy'] = int(self.pme_window_plan[1])
        caps['pme_spread_chunk'] = spread_capacity(self.ani.num_atoms,
                                                   self.pme.config)
        return caps

    def check_counts(self, counts: dict, cell_list) -> None:
        """Host-side check of counts (e.g. the maxima of a run of
        ``md.integrators.run_md_sticky_counts``) against the capacities;
        raises RuntimeError naming every count above its capacity."""
        caps = self.capacities(cell_list)
        host = {k: v.detach().cpu().numpy() for k, v in counts.items()}
        bad = {k: (host[k].tolist(), np.asarray(caps[k]).tolist())
               for k in host if np.any(host[k] > caps[k])}
        if bad:
            raise RuntimeError(
                f'capacity overflow (true count > capacity): {bad}; re-plan '
                '(with_blocked_layout margin, plan_direct_window)')

    def check_overflow(self, positions: Tensor, charges: Tensor, box: Tensor,
                       cell_list, sel=None) -> None:
        """Host-side check that no static capacity overflowed (call between
        blocks of steps)."""
        self.check_counts(self.overflow_counts(positions, charges, box,
                                               cell_list, sel), cell_list)


def plain_energy_and_forces(model: ANIWithPME, params: ANIParams,
                            positions: Tensor, charges: Tensor, box: Tensor,
                            cell_list, sel) -> Tuple[Tensor, Tensor]:
    """``model.energy_and_forces_from_selection`` with every CUDA kernel
    (ANI's and the PME window's) replaced by its plain PyTorch version, on
    any device: the reference a step through the kernels is held against on
    the card. Not a production path."""
    return model._energy_and_forces(params, positions, charges, box,
                                    cell_list, sel, True)


# ---------------------------------------------------------------------------
# BASELINE config 5 (the JAX package's examples/run_configs.py config5):
# window ANI-2x with a bf16 fused ensemble and PME electrostatics under
# Langevin BAOAB. Random weights, so the TIP3P charges are scaled by 0.2.

C5_SKIN = 0.25
C5_MARGIN = 1.2
C5_REFRESH = 5
C5_SELF_ENERGIES = np.linspace(-40.0, -1.0, 7)
C5_PME_ORDER, C5_PME_ALPHA, C5_COULOMB = 5, 0.6, 1389.35457
C5_PME_CUTOFF = 5.0
C5_CHARGE_SCALE = 0.2
C5_DT, C5_FRICTION, C5_KT = 2e-4, 5.0, 0.596


class Config5System(NamedTuple):
    """Config 5 on one water box, its tensors on one device."""
    model: ANIWithPME
    cell_list: CellList
    positions: Tensor
    box: Tensor
    charges: Tensor
    masses: Tensor


def config5(water, basis: ANIBasis, device=None) -> Config5System:
    """Config 5 on ``water`` (a ``utils.WaterBox``): the combined model with
    its bucketed PME window plan, the ANI cell list, and positions, box,
    charges (x ``C5_CHARGE_SCALE``) and masses (O 16, H 1) on ``device``
    (the card unless the caller says otherwise). The PME grid is the next
    power of two of the box edge, at least 16; no exclusions (E = 1, all
    -1). Parameters come from ``init_ani_params(...,
    self_energies=C5_SELF_ENERGIES)``."""
    dev = resolve_device(device)
    n = len(water.positions)
    ani = ANIModel.from_atomic_numbers(
        water.atomic_numbers, basis, nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(
            water.positions, water.box, margin=C5_MARGIN, impl='window',
            skin=C5_SKIN)
    if ani.aev_impl != 'window':
        raise ValueError('config 5: the window layout fell back to '
                         f'{ani.aev_impl}')
    grid = max(16, int(2 ** np.ceil(np.log2(water.box[0][0]))))
    pme = PME(grid, grid, grid, C5_PME_ORDER, C5_PME_ALPHA, C5_COULOMB,
              np.full((n, 1), -1, np.int32), device=dev)
    model = ANIWithPME.create(ani, pme, C5_PME_CUTOFF,
                              positions=water.positions, box=water.box)
    return Config5System(
        model=model, cell_list=ani.create_cell_list(water.box, skin=C5_SKIN),
        positions=torch.tensor(water.positions, device=dev),
        box=torch.tensor(water.box, device=dev),
        charges=C5_CHARGE_SCALE * torch.tensor(water.charges, device=dev),
        masses=torch.where(torch.tensor(water.atomic_numbers, device=dev)
                           == 8, 16.0, 1.0))
