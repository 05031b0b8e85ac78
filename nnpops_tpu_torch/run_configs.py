"""The five BASELINE configurations on the port, with random weights made
from a seed: the twin of the JAX package's ``examples/run_configs.py``.

Usage: python3 -m nnpops_tpu_torch.run_configs [1|2|3|4|5|all]
           [--device cpu] [--molecules N] [--steps N]

1. ANI-2x AEV + ensemble energy and forces, gas-phase methanol (the dense
   path, ``ANIModel.energy_and_forces``)
2. SchNet CFConv message passing on an aspirin-sized (21-atom) molecule
3. Periodic cell-list neighbors + ANI-2x on a 2,601-atom water box (the
   payload path, ``ANIModel.energy_and_forces_fused``)
4. PME direct + reciprocal electrostatics on the same water box
5. ANI + PME Langevin MD (``models.combined.config5``: window ANI-2x, bf16
   fused ensemble, window PME), ``--molecules`` waters, ``--steps`` steps

Everything runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .config import ANIBasis, CFConvConfig
from .md import initialize, langevin_baoab, run_md_sticky_counts
from .models import combined
from .models.ani import ANIModel, init_ani_params
from .models.schnet import SchNetModel
from .neighbors.cell_list import CellList
from .ops.batched_nn import resolve_device
from .ops.pme import PME
from .utils import make_water_box

METHANOL_Z = (6, 1, 1, 1, 8, 1)
METHANOL_POSITIONS = ((-0.046, 0.663, 0.0), (-1.097, 0.904, 0.174),
                      (0.574, 1.217, 0.705), (0.137, 0.947, -1.026),
                      (0.117, -0.716, 0.152), (1.061, -0.898, 0.033))
SELF_ENERGIES = np.linspace(-40, -1, 7)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _max_abs(f: torch.Tensor) -> float:
    return float(torch.abs(f).max())


def config1(device) -> None:
    """Gas-phase methanol: energy and forces through the composite model."""
    basis = ANIBasis.ani2x()
    model = ANIModel.from_atomic_numbers(METHANOL_Z, basis)
    params = init_ani_params(_generator(device, 0), basis,
                             self_energies=SELF_ENERGIES, device=device)
    pos = torch.tensor(METHANOL_POSITIONS, dtype=torch.float32, device=device)
    e, f = model.energy_and_forces(params, pos)
    print(f'[1] methanol: E = {float(e):.6f}, max|F| = {_max_abs(f):.4f}')


def config2(device) -> None:
    """SchNet CFConv stack on an aspirin-sized (21-atom) molecule."""
    rng = np.random.RandomState(0)
    pos = torch.tensor(rng.rand(21, 3).astype(np.float32) * 6, device=device)
    species = torch.tensor(rng.randint(0, 3, 21), device=device)
    cfg = CFConvConfig(width=128, num_gaussians=50, cutoff=10.0,
                       gaussian_width=10.0 / 49)
    model = SchNetModel(cfg, num_species=3, num_interactions=3)
    params = model.init(_generator(device, 1), device=device)
    e, f = model.energy_and_forces(params, pos, species)
    print(f'[2] schnet aspirin-like: E = {float(e):.4f}, '
          f'max|F| = {_max_abs(f):.4f}')


def config3(device) -> None:
    """Periodic 2,601-atom water box with cell-list neighbors (payload)."""
    water = make_water_box(867)
    basis = ANIBasis.ani2x()
    model = ANIModel.from_atomic_numbers(water.atomic_numbers, basis,
                                         angular_capacity=32)
    params = init_ani_params(_generator(device, 0), basis, device=device)
    box = torch.tensor(water.box, device=device)
    pos = torch.tensor(water.positions, device=device)
    cells = CellList.create(water.box, basis.radial_cutoff, capacity=96)
    e, f = model.energy_and_forces_fused(params, pos, box, cells)
    model.check_overflow(pos, box, cells)
    print(f'[3] {len(pos)}-atom water box: E = {float(e):.4f}, '
          f'max|F| = {_max_abs(f):.4f}')


def config4(device) -> None:
    """PME electrostatics (direct + reciprocal + self) on a water box."""
    water = make_water_box(867)
    n = len(water.positions)
    pme = PME(32, 32, 32, 5, 0.4, 1389.35457, np.zeros((n, 0), np.int32),
              device=device)
    box = torch.tensor(water.box, device=device)
    q = torch.tensor(water.charges, device=device)
    pos = torch.tensor(water.positions, device=device).requires_grad_(True)
    e = (pme.compute_direct(pos, q, 9.0, box, max_num_pairs=n * 64)
         + pme.compute_reciprocal(pos, q, box))
    (g,) = torch.autograd.grad(e, pos)
    print(f'[4] PME {n} atoms: E = {float(e.detach()):.2f}, '
          f'max|F| = {_max_abs(g):.2f}')


def config5(device, num_molecules: int = 150, num_steps: int = 1000) -> None:
    """ANI + PME Langevin MD with slot-sticky Verlet-skin stepping, on a
    periodic water box of ``num_molecules`` (8,670 is the 26k-atom
    production size). Random NN weights, so the charges are scaled by 0.2
    (there is no trained short-range repulsion to balance full TIP3P
    electrostatics)."""
    basis = ANIBasis.ani2x()
    system = combined.config5(make_water_box(num_molecules), basis,
                              device=device)
    ff, cells, box, charges = (system.model, system.cell_list, system.box,
                               system.charges)
    params = init_ani_params(_generator(device, 0), basis,
                             self_energies=combined.C5_SELF_ENERGIES,
                             device=device)

    def select_fn(pos):
        return ff.select(pos, box, cells)

    def force_fn_of_sel(sel, pos):
        return ff.energy_and_forces_from_selection(params, pos, charges, box,
                                                   cells, sel)

    def counts_fn(sel, pos):
        return ff.overflow_counts(pos, charges, box, cells, sel)

    state = initialize(lambda p: force_fn_of_sel(select_fn(p), p),
                       system.positions, system.masses, combined.C5_KT,
                       _generator(device, 1))
    refresh = combined.C5_REFRESH
    t0 = time.perf_counter()
    final, energies, stats = run_md_sticky_counts(
        select_fn, force_fn_of_sel,
        lambda f: langevin_baoab(f, system.masses, combined.C5_DT,
                                 combined.C5_FRICTION, combined.C5_KT),
        state, num_steps - num_steps % refresh, refresh, counts_fn)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    ff.check_counts(stats, cells)
    ff.check_overflow(final.positions, charges, box, cells)
    drift = float(energies[-1]) - float(energies[0])
    print(f'[5] {num_steps} Langevin steps ({len(system.positions)} atoms, '
          f'ANI window + PME window, sticky refresh {refresh}) in '
          f'{wall:.1f} s ({wall / num_steps * 1e3:.2f} ms/step); energy '
          f'{float(energies[0]):.3f} -> {float(energies[-1]):.3f} (drift '
          f'{drift:+.3f}), finite: '
          f'{bool(torch.isfinite(final.positions).all())}')


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('which', nargs='?', default='all',
                        choices=('1', '2', '3', '4', '5', 'all'))
    parser.add_argument('--device', default=None,
                        help="'cpu', or the CUDA card by default")
    parser.add_argument('--molecules', type=int, default=150,
                        help='water-box size for config 5 (150 = 450 atoms; '
                             '8670 = the 26k-atom production workload)')
    parser.add_argument('--steps', type=int, default=1000,
                        help='MD steps for config 5')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    configs = {'1': config1, '2': config2, '3': config3, '4': config4,
               '5': lambda d: config5(d, args.molecules, args.steps)}
    for name, fn in configs.items():
        if args.which in (name, 'all'):
            fn(device)


if __name__ == '__main__':
    main()
