"""Plain pieces the references share: the brute-force minimum-image
neighbor search and a Verlet list over it, BAOAB Langevin steps, the segment replay and the
comparison of two trajectories.

Plain PyTorch: nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def box_lengths(box: Tensor) -> Tensor:
    """The edge lengths of an orthorhombic box [3, 3]; raises on a skewed
    one (the minimum image below is the orthorhombic one)."""
    off = box - torch.diag(torch.diagonal(box))
    if bool(torch.any(off != 0)):
        raise ValueError('the reference takes orthorhombic boxes only')
    return torch.diagonal(box).clone()


def minimum_image(d: Tensor, lengths: Tensor) -> Tensor:
    """``d`` wrapped to its nearest image; the shift is a constant of the
    positions' gradient."""
    return d - lengths * torch.round(d.detach() / lengths)


@torch.no_grad()
def pairs_within(positions: Tensor, lengths: Tensor, cutoff: float,
                 block: int = 4096):
    """Every directed pair (i, j), i != j, whose minimum-image distance is
    under ``cutoff``, by brute force over blocks of rows: (i, j, r), sorted
    by i, then j."""
    n = positions.shape[0]
    out_i, out_j, out_r = [], [], []
    cols = torch.arange(n, device=positions.device)
    for r0 in range(0, n, block):
        rows = positions[r0:r0 + block]
        d = minimum_image(positions[None, :, :] - rows[:, None, :], lengths)
        r2 = torch.sum(d * d, -1)
        inside = (r2 < cutoff * cutoff) & (cols[None, :] != (
            r0 + torch.arange(rows.shape[0], device=positions.device))[:, None])
        ii, jj = inside.nonzero(as_tuple=True)
        out_i.append(ii + r0)
        out_j.append(jj)
        out_r.append(torch.sqrt(r2[ii, jj]))
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_r)


class PairList:
    """The pairs of ``pairs_within(positions, lengths, cutoff)``, taken
    from candidates that a brute-force search found within ``cutoff +
    skin``, searched again once an atom has moved ``skin / 2`` from where
    they were found (a Verlet list: any pair inside the cutoff now was
    inside ``cutoff + skin`` then). A segment's atoms move far less than
    that, so the search runs once a segment, not once a force call."""

    def __init__(self, lengths: Tensor, cutoff: float, skin: float = 1.0):
        if 2.0 * (cutoff + skin) > float(torch.min(lengths)):
            raise ValueError('cutoff + skin must be under half the box')
        self.lengths, self.cutoff, self.skin = lengths, cutoff, skin
        self.anchor = self.candidates = None

    @torch.no_grad()
    def __call__(self, positions: Tensor):
        if self.anchor is None or self.anchor.shape != positions.shape or \
                float(torch.max(torch.abs(positions - self.anchor))) * \
                math.sqrt(3.0) >= 0.5 * self.skin:
            self.anchor = positions.clone()
            self.candidates = pairs_within(positions, self.lengths,
                                           self.cutoff + self.skin)[:2]
        i, j = self.candidates
        d = minimum_image(positions[j] - positions[i], self.lengths)
        r2 = torch.sum(d * d, -1)
        keep = r2 < self.cutoff * self.cutoff
        return i[keep], j[keep], torch.sqrt(r2[keep])


@torch.no_grad()
def dense_table(i: Tensor, j: Tensor, n: int) -> Tensor:
    """[n, K] neighbor table of pairs sorted by i, padded with -1."""
    counts = torch.bincount(i, minlength=n)
    width = int(counts.max()) if i.numel() else 1
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(i.numel(), device=i.device) - starts[i]
    table = torch.full((n, max(width, 1)), -1, dtype=torch.long,
                       device=i.device)
    table[i, rank] = j
    return table


class BlockEnd(NamedTuple):
    """The state at the end of one block: positions, velocities, the
    energy and forces at those positions; the reference's also the ANI
    part of the forces."""
    positions: Tensor
    velocities: Tensor
    energy: Tensor
    forces: Tensor
    ani_forces: Optional[Tensor] = None


def trajectory(force_fn: Callable, positions: Tensor, velocities: Tensor,
               generator: torch.Generator, masses: Tensor, dt: float,
               friction: float, kT: float, blocks: int,
               refresh: int) -> List[BlockEnd]:
    """``blocks`` x ``refresh`` BAOAB Langevin steps (Leimkuhler and
    Matthews 2013) from the given start, drawing one normal [N, 3] a step
    from ``generator``; the state at each block's end. ``force_fn(x)``
    gives (energy, forces, ANI part of the forces)."""
    inv_m = (1.0 / masses)[:, None]
    c1 = float(np.exp(-friction * dt))
    c2 = float(np.sqrt(1.0 - c1 * c1))
    sigma = torch.sqrt(kT * inv_m)
    x, v = positions, velocities
    e, f, f_ani = force_fn(x)
    ends = []
    for _ in range(blocks):
        for _ in range(refresh):
            v = v + 0.5 * dt * f * inv_m
            x = x + 0.5 * dt * v
            noise = torch.randn(v.shape, generator=generator, dtype=v.dtype,
                                device=v.device)
            v = c1 * v + c2 * sigma * noise
            x = x + 0.5 * dt * v
            e, f, f_ani = force_fn(x)
            v = v + 0.5 * dt * f * inv_m
        ends.append(BlockEnd(x, v, e, f, f_ani))
    return ends


# The numbers a configuration may be held to (its ``limits`` name those it
# is); ``position_gap`` is reported beside them (see PERF.md: a segment's
# force errors move positions by less than a float32 ulp, so no lower
# precision separates it).
NUMBERS = ('energy_gap', 'force_gap', 'velocity_gap', 'ani_force_gap')
REPORTED = ('position_gap',)


def compare(run: List[BlockEnd], ref: List[BlockEnd], where=None) -> dict:
    """The widest gaps between a run's block ends and the reference's:
    energy per atom, the largest force error over the reference's largest
    force and over its largest ANI force (where another term, as PME,
    sets the largest force, the ANI forces' errors are held at their own
    scale), the largest position error (A), the largest velocity error
    over the reference's largest velocity. ``where``, a list, gets (block,
    atom, run's force, reference's force) of the largest force error."""
    out = {}
    for blk, (a, b) in enumerate(zip(run, ref)):
        n = b.positions.shape[0]
        force_err = torch.max(torch.abs(a.forces - b.forces))
        gaps = {
            'energy_gap': abs(float(a.energy) - float(b.energy)) / n,
            'force_gap': float(force_err / torch.max(torch.abs(b.forces))),
            'position_gap': float(torch.max(torch.abs(a.positions
                                                      - b.positions))),
            'velocity_gap': float(torch.max(torch.abs(a.velocities
                                                      - b.velocities))
                                  / torch.max(torch.abs(b.velocities))),
        }
        if b.ani_forces is not None:
            gaps['ani_force_gap'] = float(
                force_err / torch.max(torch.abs(b.ani_forces)))
        if where is not None and gaps['force_gap'] >= out.get('force_gap',
                                                              0.0):
            atom = int(torch.argmax(torch.max(torch.abs(a.forces - b.forces),
                                              1).values))
            where[:] = [blk, atom, a.forces[atom].tolist(),
                        b.forces[atom].tolist()]
        for k, v in gaps.items():
            out[k] = max(out.get(k, 0.0), v if np.isfinite(v) else float('inf'))
    if len(run) != len(ref):
        out = dict.fromkeys(NUMBERS + REPORTED, float('inf'))
    return out
