"""Water-box builders (the port's copy of ``nnpops_tpu.utils.water``).

Rigid TIP3P-geometry waters on a jittered cubic lattice at liquid density,
made from a numpy seed. The port keeps its own copy so that it imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the boxes
equal to the JAX package's, array by array.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

__all__ = ['WaterBox', 'make_triclinic_water_box', 'make_water_box']

# TIP3P rigid-water geometry.
_OH = 0.9572          # O-H bond length, Angstrom
_HOH = np.deg2rad(104.52)
_WATER_DENSITY = 0.0334  # molecules / A^3 at ~300 K

TIP3P_CHARGES = (-0.834, 0.417, 0.417)   # O, H, H


class WaterBox(NamedTuple):
    positions: np.ndarray       # [N, 3] float32
    atomic_numbers: np.ndarray  # [N] int (8, 1, 1, ...)
    charges: np.ndarray         # [N] float32 (TIP3P)
    box: np.ndarray             # [3, 3] float32


def _water_template() -> np.ndarray:
    h1 = np.array([_OH, 0.0, 0.0])
    h2 = np.array([_OH * np.cos(_HOH), _OH * np.sin(_HOH), 0.0])
    return np.stack([np.zeros(3), h1, h2])


def make_water_box(num_molecules: int, seed: int = 0,
                   jitter: float = 0.25) -> WaterBox:
    """A cubic box of ``num_molecules`` waters at liquid density, arranged on
    a jittered lattice with random orientations."""
    rng = np.random.RandomState(seed)
    volume = num_molecules / _WATER_DENSITY
    box_len = volume ** (1.0 / 3.0)
    n_side = int(np.ceil(num_molecules ** (1.0 / 3.0)))
    spacing = box_len / n_side

    template = _water_template()
    centers = []
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                if len(centers) < num_molecules:
                    centers.append((np.array([i, j, k]) + 0.5) * spacing)
    centers = np.asarray(centers)
    centers += rng.uniform(-jitter, jitter, centers.shape) * spacing / 2

    positions = np.empty((num_molecules * 3, 3), dtype=np.float64)
    for m, center in enumerate(centers):
        # Random rotation via QR of a Gaussian matrix.
        q, r = np.linalg.qr(rng.randn(3, 3))
        q *= np.sign(np.diag(r))
        positions[3 * m:3 * m + 3] = center + template @ q.T
    positions %= box_len

    atomic_numbers = np.tile([8, 1, 1], num_molecules)
    charges = np.tile(np.asarray(TIP3P_CHARGES, dtype=np.float32), num_molecules)
    box = (np.eye(3) * box_len).astype(np.float32)
    return WaterBox(positions.astype(np.float32), atomic_numbers, charges, box)


def make_triclinic_water_box(num_molecules: int, seed: int = 0,
                             jitter: float = 0.25,
                             shear: Tuple[float, float, float] = (0.15, 0.10, 0.12),
                             ) -> WaterBox:
    """The cubic water box re-wrapped into a reduced lower-triangular
    triclinic cell (b_x = shear[0] * L, c_x = shear[1] * L,
    c_y = shear[2] * L), within the reduced-form bounds so that one
    minimum-image wrap per axis stays valid."""
    w = make_water_box(num_molecules, seed=seed, jitter=jitter)
    L = float(w.box[0, 0])
    box = np.array([[L, 0.0, 0.0],
                    [shear[0] * L, L, 0.0],
                    [shear[1] * L, shear[2] * L, L]], np.float64)
    frac = w.positions.astype(np.float64) @ np.linalg.inv(box)
    pos = (frac - np.floor(frac)) @ box
    return WaterBox(pos.astype(np.float32), w.atomic_numbers, w.charges,
                    box.astype(np.float32))
