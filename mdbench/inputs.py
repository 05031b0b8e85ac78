"""The benchmark's inputs, made from the seed: the water frame, the
ensemble's weights, charges, masses and the restart states of the MD
segments. The program and the reference are handed the same tensors.

The water frame is the benchmark's own frozen copy of the lattice
generator the port ships (rigid TIP3P waters on a jittered cubic lattice at
liquid density), so a later change to the port cannot move the inputs.
The frame comes from the traffic's ``frame_seed``, so every run plans the
same capacities and launches the same shapes; ``--seed`` moves every
segment's start by a small displacement, and draws its velocities, the
Langevin noise and the weights.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_OH = 0.9572                 # O-H bond length, Angstrom (TIP3P)
_HOH = np.deg2rad(104.52)    # H-O-H angle (TIP3P)
WATER_DENSITY = 0.0334       # molecules / A^3 at ~300 K
TIP3P_CHARGES = (-0.834, 0.417, 0.417)


class Frame(NamedTuple):
    positions: np.ndarray       # [N, 3] float32
    atomic_numbers: np.ndarray  # [N] int64 (8, 1, 1, ...)
    charges: np.ndarray         # [N] float32, TIP3P
    box: np.ndarray             # [3, 3] float32, cubic


def water_frame(num_molecules: int, seed: int, jitter: float = 0.25) -> Frame:
    """A cubic box of ``num_molecules`` waters at liquid density on a
    jittered lattice with random orientations."""
    rng = np.random.RandomState(seed)
    box_len = (num_molecules / WATER_DENSITY) ** (1.0 / 3.0)
    n_side = int(np.ceil(num_molecules ** (1.0 / 3.0)))
    spacing = box_len / n_side
    template = np.stack([np.zeros(3), np.array([_OH, 0.0, 0.0]),
                         np.array([_OH * np.cos(_HOH), _OH * np.sin(_HOH),
                                   0.0])])
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing='ij'), -1)
    centers = (grid.reshape(-1, 3)[:num_molecules] + 0.5) * spacing
    centers = centers + rng.uniform(-jitter, jitter, centers.shape) * spacing / 2
    positions = np.empty((num_molecules * 3, 3), dtype=np.float64)
    for m, center in enumerate(centers):
        q, r = np.linalg.qr(rng.randn(3, 3))
        q *= np.sign(np.diag(r))
        positions[3 * m:3 * m + 3] = center + template @ q.T
    positions %= box_len
    return Frame(positions.astype(np.float32),
                 np.tile(np.array([8, 1, 1], np.int64), num_molecules),
                 np.tile(np.asarray(TIP3P_CHARGES, np.float32), num_molecules),
                 (np.eye(3) * box_len).astype(np.float32))


def sub_seed(seed: int, *tags: int) -> int:
    """A 62-bit seed for one purpose of a run: any whole ``seed`` and the
    purpose's integer tags."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), *tags]
                                   ).generate_state(2, dtype=np.uint32)
    return (int(words[0]) << 30) ^ int(words[1])


def generator(device, seed: int, *tags: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tags))
    return gen


# Purpose tags of sub_seed.
WEIGHTS, DISPLACEMENT, VELOCITIES = 1, 2, 3


class Weights(NamedTuple):
    """Per species: weights[l] [models, out, in] (bf16 values held in
    float32) and biases[l] [models, out] (float32)."""
    weights: tuple
    biases: tuple


def make_weights(seed: int, layer_dims, aev_length: int, num_models: int,
                 bias_scale: float, device) -> list:
    """Every species' ensemble from one generator on ``device``, in two
    draws: the weights (fan-in scaled normals, rounded to bf16, the type
    the fused ensemble serves them in) and the biases (float32)."""
    shapes = []
    for dims in layer_dims:
        full = [aev_length, *dims, 1]
        shapes.append([(num_models, full[i + 1], full[i])
                       for i in range(len(full) - 1)])
    gen = generator(device, seed, WEIGHTS)
    w_total = sum(int(np.prod(s)) for sp in shapes for s in sp)
    b_total = sum(s[0] * s[1] for sp in shapes for s in sp)
    w_flat = torch.randn(w_total, generator=gen, device=device)
    b_flat = bias_scale * torch.randn(b_total, generator=gen, device=device)
    out, wo, bo = [], 0, 0
    for sp in shapes:
        ws, bs = [], []
        for m, o, i in sp:
            w = w_flat[wo:wo + m * o * i].view(m, o, i) * (1.0 / np.sqrt(i))
            ws.append(w.to(torch.bfloat16).float())
            bs.append(b_flat[bo:bo + m * o].view(m, o).clone())
            wo += m * o * i
            bo += m * o
        out.append(Weights(tuple(ws), tuple(bs)))
    return out


class Restart(NamedTuple):
    positions: torch.Tensor      # [N, 3]
    velocities: torch.Tensor     # [N, 3]
    generator: torch.Generator   # the Langevin noise's, after the velocities


def restart(seed: int, segment: int, frame_positions: torch.Tensor,
            masses: torch.Tensor, kT: float, displacement: float) -> Restart:
    """Segment ``segment``'s start: the frame moved by a seeded Gaussian
    displacement of ``displacement`` A per coordinate, Maxwell-Boltzmann
    velocities at ``kT``, and the generator that then draws the segment's
    Langevin noise."""
    dev = frame_positions.device
    shape = frame_positions.shape
    disp = torch.randn(shape, generator=generator(dev, seed, DISPLACEMENT,
                                                  segment), device=dev)
    gen = generator(dev, seed, VELOCITIES, segment)
    sigma = torch.sqrt(kT / masses)[:, None]
    vel = sigma * torch.randn(shape, generator=gen, device=dev)
    return Restart(frame_positions + displacement * disp, vel, gen)


def masses_of(atomic_numbers: np.ndarray, table: dict, device) -> torch.Tensor:
    """[N] float32 masses from the configuration's table (atomic number as
    a string -> mass)."""
    m = np.array([table[str(int(z))] for z in atomic_numbers], np.float32)
    return torch.tensor(m, device=device)
