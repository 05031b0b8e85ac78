"""MD integrators as step functions (port of ``nnpops_tpu.md.integrators``).

* ``langevin_baoab``: the BAOAB splitting of Langevin dynamics (Leimkuhler
  & Matthews 2013), one force evaluation per step.
* ``velocity_verlet``: NVE, for energy-drift validation.
* ``run_md``, ``run_md_sticky``, ``run_md_sticky_counts``: trajectories,
  the sticky ones refreshing the neighbor selection every few steps.

Port notes: ``lax.scan`` and ``fori_loop`` become Python loops. The JAX
key becomes a ``torch.Generator`` held in the state, on the state's
device; it advances in place (a step returns a state holding the same
generator object), so a state is a snapshot of everything but the
generator. ``md.checkpoint`` saves the generator's state, so a resumed
run draws the same numbers. ``jax.random`` and ``torch`` draw different
numbers from one seed: tests that compare with JAX use ``velocity_verlet``
or Langevin at ``kT = 0``. Nothing here reads a value on the host:
energies and the count maxima stay device tensors until the caller reads
them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
ForceFn = Callable[[Tensor], Tuple[Tensor, Tensor]]   # positions -> (energy, forces)


class MDState(NamedTuple):
    """Simulation state (SURVEY §5: 'MD state (positions, velocities, RNG
    key) checkpoints as a pytree'); ``generator`` stands for the JAX key."""
    positions: Tensor              # [N, 3]
    velocities: Tensor             # [N, 3]
    forces: Tensor                 # [N, 3] forces at `positions`
    energy: Tensor                 # [] potential energy at `positions`
    generator: torch.Generator     # on the positions' device
    step: Tensor                   # [] int32


def initialize(force_fn: ForceFn, positions: Tensor, masses: Tensor,
               kT: float, generator: torch.Generator) -> MDState:
    """Initial state with Maxwell-Boltzmann velocities drawn from
    ``generator`` (which the state then holds)."""
    sigma = torch.sqrt(kT / masses)[:, None]
    velocities = sigma * torch.randn(positions.shape, generator=generator,
                                     dtype=positions.dtype,
                                     device=positions.device)
    energy, forces = force_fn(positions)
    return MDState(positions, velocities, forces, energy, generator,
                   torch.zeros((), dtype=torch.int32, device=positions.device))


def langevin_baoab(force_fn: ForceFn, masses: Tensor, dt: float,
                   friction: float, kT: float) -> Callable[[MDState], MDState]:
    """One BAOAB Langevin step: B (half kick), A (half drift), O
    (thermostat), A (half drift), B (half kick with fresh forces)."""
    inv_m = (1.0 / masses)[:, None]
    c1 = float(np.exp(-friction * dt))
    c2 = float(np.sqrt(1.0 - c1 * c1))
    sigma = torch.sqrt(kT * inv_m)

    def step(state: MDState) -> MDState:
        v = state.velocities + 0.5 * dt * state.forces * inv_m
        x = state.positions + 0.5 * dt * v
        noise = torch.randn(v.shape, generator=state.generator, dtype=v.dtype,
                            device=v.device)
        v = c1 * v + c2 * sigma * noise
        x = x + 0.5 * dt * v
        energy, forces = force_fn(x)
        v = v + 0.5 * dt * forces * inv_m
        return MDState(x, v, forces, energy, state.generator, state.step + 1)

    return step


def velocity_verlet(force_fn: ForceFn, masses: Tensor,
                    dt: float) -> Callable[[MDState], MDState]:
    """One NVE velocity-Verlet step."""
    inv_m = (1.0 / masses)[:, None]

    def step(state: MDState) -> MDState:
        v_half = state.velocities + 0.5 * dt * state.forces * inv_m
        x = state.positions + dt * v_half
        energy, forces = force_fn(x)
        v = v_half + 0.5 * dt * forces * inv_m
        return MDState(x, v, forces, energy, state.generator, state.step + 1)

    return step


class OverflowStats(NamedTuple):
    """Maximum TRUE capacity counts observed over a sticky-MD run (device
    tensors); compare against the static capacities on the host after the
    run (getNeighborPairs.py:77-83, "check between scan segments")."""
    max_neighbors: Tensor        # [] int, vs CellList.capacity
    max_cell_occupancy: Tensor   # [] int, vs CellList.cell_capacity
    max_extra: Tensor            # [] int, from overflow_fn

    def check(self, capacity: int, cell_capacity: int,
              extra_capacity: Optional[int] = None) -> None:
        bad = {}
        if int(self.max_neighbors) > capacity:
            bad['max_neighbors'] = (int(self.max_neighbors), capacity)
        if int(self.max_cell_occupancy) > cell_capacity:
            bad['max_cell_occupancy'] = (int(self.max_cell_occupancy),
                                         cell_capacity)
        if extra_capacity is not None and int(self.max_extra) > extra_capacity:
            bad['max_extra'] = (int(self.max_extra), extra_capacity)
        if bad:
            raise RuntimeError(
                f'neighbor capacity overflow during MD (true > capacity): {bad}')


def _sticky_block(select_fn, force_fn_of_sel, integrator_factory, state,
                  refresh_every):
    """One refresh block: a fresh selection, the forces at the block's
    start against it, then ``refresh_every`` steps. Returns (state, sel)."""
    sel = select_fn(state.positions)
    force_fn = lambda pos: force_fn_of_sel(sel, pos)  # noqa: E731
    step = integrator_factory(force_fn)
    energy, forces = force_fn(state.positions)
    state = state._replace(energy=energy, forces=forces)
    for _ in range(refresh_every):
        state = step(state)
    return state, sel


def run_md_sticky(select_fn: Callable, force_fn_of_sel: Callable,
                  integrator_factory: Callable, state: MDState,
                  num_steps: int, refresh_every: int,
                  overflow_fn: Optional[Callable] = None):
    """Slot-sticky (Verlet-list) MD: refresh the neighbor selection every
    ``refresh_every`` steps, reuse it in between. Valid while no atom moves
    more than skin/2 per block.

    ``select_fn``: positions -> selection with ``max_neighbors`` and
    ``max_cell_occupancy`` counts; ``force_fn_of_sel``: (selection,
    positions) -> (energy, forces); ``integrator_factory``: force_fn ->
    one-step function; ``overflow_fn``: optional (selection, positions) ->
    an extra true count. Returns (final_state, per-block energies [blocks],
    OverflowStats); ``stats.check`` on the host after the run."""
    energies = []
    zero = torch.zeros((), dtype=torch.int32, device=state.positions.device)
    stats = OverflowStats(zero, zero, zero)
    for _ in range(num_steps // refresh_every):
        start = state.positions
        state, sel = _sticky_block(select_fn, force_fn_of_sel,
                                   integrator_factory, state, refresh_every)
        extra = overflow_fn(sel, start) if overflow_fn else zero
        stats = OverflowStats(
            torch.maximum(stats.max_neighbors, sel.max_neighbors),
            torch.maximum(stats.max_cell_occupancy, sel.max_cell_occupancy),
            torch.maximum(stats.max_extra, extra))
        energies.append(state.energy)
    return state, torch.stack(energies), stats


def run_md_sticky_counts(select_fn: Callable, force_fn_of_sel: Callable,
                         integrator_factory: Callable, state: MDState,
                         num_steps: int, refresh_every: int,
                         counts_fn: Callable):
    """Slot-sticky MD for any selection type: like :func:`run_md_sticky`,
    with overflow tracking by ``counts_fn(sel, positions) -> dict`` of true
    capacity counts (e.g. ``ANIWithPME.overflow_counts`` with ``sel``
    passed through), taken at each block's start. The stats dict holds the
    elementwise max of every count over all blocks, as device tensors.

    Returns (final_state, per-block energies [blocks], stats_dict)."""
    energies, stats = [], None
    for _ in range(num_steps // refresh_every):
        start = state.positions
        state, sel = _sticky_block(select_fn, force_fn_of_sel,
                                   integrator_factory, state, refresh_every)
        new = {k: torch.as_tensor(v) for k, v in counts_fn(sel, start).items()}
        stats = new if stats is None else {
            k: torch.maximum(stats[k], new[k]) for k in stats}
        energies.append(state.energy)
    return state, torch.stack(energies), stats


def kinetic_energy(state: MDState, masses: Tensor) -> Tensor:
    return 0.5 * torch.sum(masses[:, None] * state.velocities ** 2)


def run_md(step_fn: Callable[[MDState], MDState], state: MDState,
           num_steps: int, record_every: int = 1):
    """Run ``num_steps`` steps; returns (final_state, energies) with the
    potential energy after every ``record_every`` steps."""
    energies = []
    for _ in range(num_steps // record_every):
        for _ in range(record_every):
            state = step_fn(state)
        energies.append(state.energy)
    return state, torch.stack(energies)
