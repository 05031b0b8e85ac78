"""The composite ANI model (port of ``nnpops_tpu.models.ani``, the
species-blocked and window paths).

Species conversion -> AEV -> species-grouped ensemble -> self energies,
with forces from ``torch.autograd.grad`` on the positions. The Verlet-skin
selection (``select``) is refreshed every few steps; every step runs only
the differentiable phase (``energy_and_forces_from_selection``).

Implemented ``aev_impl`` values: 'window' (the production path: window
selection with the left-pack kernel, window radial kernel, tiered angular
kernel), 'blocked' (PyTorch angular block) and 'pallas' (the angular CUDA
kernel; the names are kept from the JAX package). ``window_radial``, the
window path's radial kernel: 'window' (the default), 'pair' (the symmetric
z-pair kernel) or 'cluster' (the cluster-pair kernel over a planned
``ClusterPlan``). ``nn_impl``: 'xla' (PyTorch reference of the grouped
ensemble, f32 or ``nn_dtype='bfloat16'``) or 'fused' (the fused-NN CUDA
kernel, bf16 operands). The dense and payload AEV paths (ROADMAP A.4, A.6)
raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ANI2X_ELEMENTS, ANI2X_LAYER_DIMS, ANIBasis

from ..neighbors.blocked import (BlockedLayout, payload_from_blocked,
                                 plan_blocked_layout, select_blocked)
from ..neighbors.cell_list import CellList
from ..neighbors.clusters import plan_clusters
from ..neighbors.window import (RADIAL_IMPLS, WindowSelection,
                                plan_angular_tiers, plan_window_cells,
                                select_window, window_features)
from ..ops.aev_blocked import compute_aev_blocked
from ..ops.batched_nn import (EnsembleParams, SpeciesGrouping, build_grouping,
                              ensemble_energy_grouped_rows, init_ensemble,
                              resolve_device)
from ..ops.cuda_nn import (ensemble_energy_grouped_rows_fused,
                           ensemble_energy_grouped_rows_fused_plain)

def species_from_atomic_numbers(atomic_numbers,
                                elements: Sequence[int] = ANI2X_ELEMENTS,
                                ) -> np.ndarray:
    """Atomic numbers -> dense species indices; raises on unsupported
    elements."""
    table = -np.ones(int(max(elements)) + 1, dtype=np.int32)
    for i, z in enumerate(elements):
        table[z] = i
    z = np.asarray(atomic_numbers, dtype=np.int64)
    if (z < 0).any() or (z >= len(table)).any() or (table[z] < 0).any():
        raise ValueError(f'unsupported atomic numbers for elements {tuple(elements)}')
    return table[z].astype(np.int32)


class ANIParams(NamedTuple):
    """Parameters of an ANI model."""
    ensemble: EnsembleParams
    self_energies: torch.Tensor   # [num_species]


def init_ani_params(generator: torch.Generator, basis: ANIBasis,
                    layer_dims: Sequence[Sequence[int]] = ANI2X_LAYER_DIMS,
                    num_models: int = 8,
                    self_energies: Optional[np.ndarray] = None,
                    device=None) -> ANIParams:
    """Random parameters from a seeded ``torch.Generator`` (fan-in scaled as
    in the JAX init; the numbers differ), on the CUDA card unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    ens = init_ensemble(generator, basis.aev_length, layer_dims, num_models,
                        device=device)
    if self_energies is None:
        sae = torch.zeros(basis.num_species, dtype=torch.float32, device=device)
    else:
        sae = torch.as_tensor(np.asarray(self_energies), dtype=torch.float32,
                              device=device)
    return ANIParams(ens, sae)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class ANIModel:
    """A system-bound ANI model: basis + static species assignment."""
    basis: ANIBasis
    species: Tuple[int, ...]
    aev_impl: str = 'payload'
    blocked_layout: Optional[BlockedLayout] = None
    nn_dtype: Optional[str] = None
    nn_impl: str = 'xla'
    window_radial: str = 'window'

    def __post_init__(self):
        if self.window_radial not in RADIAL_IMPLS:
            raise ValueError(f'window_radial={self.window_radial!r} not in '
                             f'{RADIAL_IMPLS}')
        if self.nn_impl not in ('xla', 'fused'):
            raise ValueError(f"nn_impl={self.nn_impl!r} not in ('xla', 'fused')")

    @classmethod
    def from_atomic_numbers(cls, atomic_numbers,
                            basis: Optional[ANIBasis] = None,
                            elements: Sequence[int] = ANI2X_ELEMENTS,
                            aev_impl: str = 'payload',
                            blocked_layout=None,
                            nn_dtype: Optional[str] = None,
                            nn_impl: str = 'xla') -> 'ANIModel':
        basis = basis if basis is not None else ANIBasis.ani2x()
        sp = species_from_atomic_numbers(atomic_numbers, elements)
        return cls(basis=basis, species=tuple(int(s) for s in sp),
                   aev_impl=aev_impl, blocked_layout=blocked_layout,
                   nn_dtype=nn_dtype, nn_impl=nn_impl)

    def with_blocked_layout(self, positions, box, margin: float = 1.2,
                            impl: str = 'blocked',
                            skin: float = 0.0,
                            radial_impl: Optional[str] = None) -> 'ANIModel':
        """A copy configured for a species-blocked AEV path, with capacities
        planned from this configuration. ``impl``: 'blocked' (PyTorch
        angular), 'pallas' (angular CUDA kernel) or 'window' (window radial
        kernel + tiered angular kernel, the production path; it needs a
        periodic box at least 3 cells wide and falls back to 'pallas'
        without one). ``skin`` widens every capacity window for Verlet-skin
        stepping. Window mode rounds the lane capacities up to multiples
        of 8, also when it falls back. ``radial_impl`` (window mode only,
        ignored otherwise, as in the JAX package) sets ``window_radial``;
        'cluster' plans the clusters and keeps 'window' when the planner
        refuses the box (strongly triclinic, or too small for one image
        shift per cluster pair)."""
        if radial_impl not in (None,) + RADIAL_IMPLS:
            raise ValueError(f'radial_impl={radial_impl!r} not in '
                             f'{RADIAL_IMPLS}')
        if impl not in ('blocked', 'pallas', 'window'):
            raise ValueError(f"impl={impl!r} not in ('blocked', 'pallas', "
                             "'window')")
        pos = _host(positions)
        box = None if box is None else _host(box)
        present = tuple(int(s) for s in np.unique(self.species_array))
        cell_grid = cell_caps = small_caps = num_big = None
        lane_multiple = 8 if impl == 'window' else 1
        if impl == 'window':
            if box is not None:
                (cell_grid, cell_caps, small_caps,
                 num_big) = plan_window_cells(
                    pos, box, self.species_array, present,
                    self.basis.radial_cutoff + skin, margin=margin)
            if cell_grid is None:
                impl = 'pallas'      # no cell grid: window mode impossible
        layout = plan_blocked_layout(
            pos, box, self.species_array, self.basis.radial_cutoff + skin,
            self.basis.angular_cutoff + skin, self.basis.num_species,
            margin=margin, lane_multiple=lane_multiple)
        if cell_caps is not None:
            tier_caps, tier_rows = plan_angular_tiers(
                pos, box, self.species_array, layout.present,
                self.basis.angular_cutoff + skin, layout.ang_caps)
            # A dedicated angular candidate grid (cells sized by the angular
            # window), unless it would not be finer than the radial grid.
            ang_grid, ang_ccaps, _, _ = plan_window_cells(
                pos, box, self.species_array, present,
                self.basis.angular_cutoff + skin, margin=margin,
                pad_multiple=1)
            if ang_grid is None or np.prod(ang_grid) <= np.prod(cell_grid):
                ang_grid = ang_ccaps = None
            layout = dataclasses.replace(
                layout, cell_caps=cell_caps, cell_grid=cell_grid,
                small_caps=small_caps, num_big_cells=num_big,
                ang_tier_caps=tier_caps, ang_tier_rows=tier_rows,
                ang_cell_caps=ang_ccaps, ang_cell_grid=ang_grid)
        window_radial = self.window_radial
        if impl == 'window' and radial_impl is not None:
            if radial_impl == 'cluster':
                plan = plan_clusters(pos, box, self.species_array,
                                     self.basis.radial_cutoff, skin=skin,
                                     margin=margin)
                if plan is None:
                    radial_impl = 'window'   # unsuitable box: keep window
                else:
                    layout = dataclasses.replace(layout, cluster_plan=plan)
            window_radial = radial_impl
        return dataclasses.replace(self, aev_impl=impl, blocked_layout=layout,
                                   window_radial=window_radial)

    def create_cell_list(self, box, skin: float = 0.0):
        """The matching CellList for this model's planned layout: window
        mode needs the cell capacity to equal the planned species-sub-block
        total (``select_window`` checks)."""
        cell_capacity = None
        if self.aev_impl == 'window' and self.blocked_layout.cell_caps:
            cell_capacity = sum(self.blocked_layout.cell_caps)
        return CellList.create(_host(box), self.basis.radial_cutoff + skin,
                               capacity=self.blocked_layout.rad_total,
                               cell_capacity=cell_capacity)

    @property
    def num_atoms(self) -> int:
        return len(self.species)

    @property
    def species_array(self) -> np.ndarray:
        return np.asarray(self.species, dtype=np.int32)

    @property
    def nn_compute_dtype(self) -> Optional[torch.dtype]:
        if self.nn_dtype in ('bfloat16', torch.bfloat16):
            return torch.bfloat16
        return None

    @functools.cached_property
    def grouping(self) -> SpeciesGrouping:
        return build_grouping(self.species_array, self.basis.num_species)

    @functools.lru_cache(maxsize=4)
    def _device_arrays(self, device: torch.device):
        """Species-grouping order and species ids on ``device``, made once
        (a host-to-device copy inside the step would synchronise it)."""
        return (torch.as_tensor(self.grouping.order, device=device).long(),
                torch.as_tensor(self.species_array, device=device).long())

    def _require_blocked(self):
        if self.aev_impl not in ('blocked', 'pallas', 'window'):
            raise NotImplementedError(
                f'aev_impl={self.aev_impl!r}: the port implements the '
                "species-blocked paths ('blocked', 'pallas', 'window'); call "
                'with_blocked_layout first (the dense and payload AEV paths '
                'are ROADMAP A.4/A.6)')

    def select(self, positions: torch.Tensor, box: torch.Tensor, cell_list):
        """Freeze a neighbor selection for sticky (Verlet-skin) stepping: a
        WindowSelection in window mode, else a BlockedSelection."""
        self._require_blocked()
        if self.aev_impl == 'window':
            g = self.grouping
            return select_window(
                cell_list, positions, box, self.species_array,
                self.blocked_layout, self.basis.radial_cutoff,
                self.basis.angular_cutoff, grouping_order=g.order,
                present_counts=tuple(g.counts[s]
                                     for s in self.blocked_layout.present),
                need_shift_planes=self.window_radial == 'window',
                cluster_plan=(self.blocked_layout.cluster_plan
                              if self.window_radial == 'cluster' else None))
        return select_blocked(cell_list, positions, box, self.species_array,
                              self.blocked_layout, self.basis.radial_cutoff,
                              self.basis.angular_cutoff)

    def overflow_counts(self, positions, box, cell_list, sel=None) -> dict:
        """True counts for every static capacity of the pipeline (per present
        species for the lane and cell-slot capacities). The window radial is
        capacity-free; its capacities are the per-(cell, species)
        occupancies, the angular lanes, the big-cell count and the tier
        rows. A cluster selection adds its j-cluster and candidate counts,
        the most entries on one j-cluster and the geometric bound (0/1)."""
        self._require_blocked()
        sel = sel if sel is not None else self.select(positions, box, cell_list)
        if self.aev_impl != 'window':
            return {'max_neighbors': sel.max_rad,
                    'max_cell_occupancy': sel.max_cell_occupancy,
                    'max_angular': sel.max_ang}
        counts = {'max_neighbors': sel.ang.max_rad,
                  'max_cell_occupancy': sel.max_cell_sp,
                  'max_angular': sel.ang.max_ang}
        if self.blocked_layout.ang_cell_grid is not None:
            counts['max_cell_occupancy_ang'] = sel.max_cell_sp_ang
        if self.blocked_layout.num_big_cells is not None:
            counts['num_big_cells'] = sel.n_big_true
        if sel.tier is not None:
            counts['ang_tier_rows'] = sel.tier.tier_counts
        if sel.clusters is not None:
            counts['cluster_jcount'] = sel.clusters.max_jcount
            counts['cluster_cand'] = sel.clusters.max_cand
            counts['cluster_mirror'] = sel.clusters.max_mir
            counts['cluster_geom'] = sel.clusters.geom_violation.to(
                torch.int32)
        return counts

    def _capacities(self, cell_list) -> dict:
        """The capacity each overflow count is held against."""
        layout = self.blocked_layout
        if self.aev_impl != 'window':
            return {'max_neighbors': np.asarray(layout.rad_caps),
                    'max_cell_occupancy': cell_list.cell_capacity,
                    'max_angular': np.asarray(layout.ang_caps)}
        caps = {'max_neighbors': np.asarray(layout.ang_caps),
                'max_cell_occupancy': np.asarray(layout.cell_caps),
                'max_angular': np.asarray(layout.ang_caps)}
        if layout.ang_cell_grid is not None:
            caps['max_cell_occupancy_ang'] = np.asarray(layout.ang_cell_caps)
        if layout.num_big_cells is not None:
            caps['num_big_cells'] = layout.num_big_cells
        if layout.ang_tier_rows is not None:
            caps['ang_tier_rows'] = np.cumsum(np.asarray(layout.ang_tier_rows),
                                              axis=0)
        plan = layout.cluster_plan
        if plan is not None:
            caps.update(cluster_jcount=np.asarray(plan.jcaps),
                        cluster_cand=np.asarray(plan.cand_caps),
                        cluster_mirror=plan.kmir, cluster_geom=0)
        return caps

    def check_overflow(self, positions, box, cell_list, sel=None) -> None:
        """Host-side check that no static capacity overflowed; raises
        RuntimeError naming every count above its capacity."""
        raw = self.overflow_counts(positions, box, cell_list, sel)
        counts = {k: v.detach().cpu().numpy() for k, v in raw.items()}
        caps = self._capacities(cell_list)
        bad = {k: (counts[k].tolist(), np.asarray(caps[k]).tolist())
               for k in counts if np.any(counts[k] > caps[k])}
        if bad:
            raise RuntimeError(
                f'neighbor capacity overflow (true count > capacity): {bad}; '
                'rebuild with larger capacities (with_blocked_layout margin)')

    def energy_from_selection(self, params: ANIParams,
                              positions: torch.Tensor, box: torch.Tensor,
                              cell_list, sel) -> torch.Tensor:
        """Energy against a frozen neighbor selection: payload, AEV (rows
        species-grouped), ensemble and self energies."""
        return self._energy(params, positions, box, cell_list, sel, False)

    def _energy(self, params, positions, box, cell_list, sel, plain: bool):
        """``plain`` swaps every kernel for its plain PyTorch version (see
        :func:`plain_energy_and_forces`)."""
        self._require_blocked()
        order, species = self._device_arrays(positions.device)
        if isinstance(sel, WindowSelection):
            # Rows come out species-grouped (in the tiers' order within a
            # species block), so the ensemble runs on row slices.
            feat = window_features(cell_list, positions, box, sel, self.basis,
                                   self.blocked_layout, atom_order=order,
                                   plain=plain,
                                   radial_impl=self.window_radial)
        else:
            pallas = self.aev_impl == 'pallas'
            # The species grouping composed into the payload's row order:
            # AEV rows come out species-grouped, so the ensemble runs on row
            # slices.
            payload = payload_from_blocked(cell_list, positions, box, sel,
                                           rad_only=pallas,
                                           layout=self.blocked_layout,
                                           row_order=sel.inv_order[order])
            radial, angular = compute_aev_blocked(
                payload, self.basis, self.blocked_layout,
                angular_impl='cuda' if pallas and not plain else 'plain')
            feat = torch.cat([radial, angular], 1)
        counts = self.grouping.counts
        if self.nn_impl == 'fused':
            fused = (ensemble_energy_grouped_rows_fused_plain if plain
                     else ensemble_energy_grouped_rows_fused)
            e_nn = fused(params.ensemble, feat, counts)
        else:
            e_nn = ensemble_energy_grouped_rows(params.ensemble, feat, counts,
                                                self.nn_compute_dtype)
        sae = torch.sum(params.self_energies[species])
        return e_nn + sae

    def energy_fused(self, params: ANIParams, positions: torch.Tensor,
                     box: torch.Tensor, cell_list) -> torch.Tensor:
        """Total energy with the selection built inline: ``select`` then
        ``energy_from_selection``. The payload-carrying path of the JAX
        package needs ``CellList.build_payload`` (ROADMAP A.4/A.6) and
        raises."""
        self._require_blocked()
        return self.energy_from_selection(
            params, positions, box, cell_list,
            self.select(positions, box, cell_list))

    def energy_and_forces_from_selection(self, params: ANIParams,
                                         positions: torch.Tensor,
                                         box: torch.Tensor, cell_list,
                                         sel) -> Tuple[torch.Tensor, torch.Tensor]:
        """Energy and forces = -dE/dpositions against a frozen selection."""
        return self._energy_and_forces(params, positions, box, cell_list, sel,
                                       False)

    def _energy_and_forces(self, params, positions, box, cell_list, sel,
                           plain: bool):
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = self._energy(params, pos, box, cell_list, sel, plain)
            (grad,) = torch.autograd.grad(e, pos)
        return e.detach(), -grad


def plain_energy_and_forces(model: ANIModel, params: ANIParams,
                            positions: torch.Tensor, box: torch.Tensor,
                            cell_list, sel) -> Tuple[torch.Tensor, torch.Tensor]:
    """``model.energy_and_forces_from_selection`` with every CUDA kernel
    replaced by its plain PyTorch version, on any device: the reference a
    step through the kernels is held against on the card. Not a production
    path (the plain versions are slow)."""
    return model._energy_and_forces(params, positions, box, cell_list, sel,
                                    True)
