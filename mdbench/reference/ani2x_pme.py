"""The plain reference of the ``ani2x_pme`` kind: ANI-2x plus smooth
particle-mesh Ewald electrostatics (Essmann et al., J. Chem. Phys. 103,
8577, 1995).

PME from the textbook: the direct sum ``k q_i q_j erfc(alpha r) / r`` over
every pair inside the cutoff (minimum image, no exclusions); the
reciprocal sum ``k / (2 pi V) sum_{m != 0} exp(-pi^2 |m|^2 / alpha^2) /
|m|^2 B(m) |F(Q)(m)|^2`` with ``Q`` the charges spread by order-n cardinal
B-splines ``M_n`` onto the grid, ``B`` the splines' Euler factors (an
axis's zero, at half the grid for odd orders, takes its neighbors' mean, as
OpenMM and NNPOps do) and a full complex FFT; the self term ``-k alpha /
sqrt(pi) sum q^2``. Forces by autograd. ``control=True`` spreads, and sums
the direct pairs, in bfloat16 too; ``control='ensemble'`` keeps PME in
float32.

Plain PyTorch: it imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mdbench import work
from mdbench.reference import ani2x_window

Tensor = torch.Tensor


def bspline_pieces(w: Tensor, order: int) -> Tensor:
    """[..., order]: the cardinal B-spline M_order at ``w + k``, k = 0 ..
    order - 1, for ``w`` in [0, 1): the recursion M_n(x) = (x M_{n-1}(x) +
    (n - x) M_{n-1}(x - 1)) / (n - 1) on the polynomial pieces, from M_2 =
    (w, 1 - w), so the derivative in ``w`` has no kink at a grid point."""
    m = [w, 1.0 - w]
    for n in range(3, order + 1):
        m = [((w + k) * (m[k] if k < n - 1 else 0.0)
              + (n - w - k) * (m[k - 1] if k >= 1 else 0.0)) / (n - 1)
             for k in range(n)]
    return torch.stack(m, -1)


def euler_factors(size: int, order: int) -> np.ndarray:
    """B(m) of one axis, float64: 1 / |sum_k M_n(k + 1) exp(2 pi i m k /
    size)|^2; a zero of the sum takes its neighbors' mean first."""
    knots = bspline_pieces(torch.zeros((), dtype=torch.float64),
                           order).numpy()[1:]
    m = np.arange(size)
    arg = 2.0 * np.pi * np.outer(m, np.arange(order - 1)) / size
    mod = (knots * np.cos(arg)).sum(1) ** 2 + (knots * np.sin(arg)).sum(1) ** 2
    small = mod < 1e-7
    mod = np.where(small, 0.5 * (np.roll(mod, 1) + np.roll(mod, -1)), mod)
    return 1.0 / mod


class Reference(ani2x_window.Reference):

    def __init__(self, cfg: dict, setup):
        super().__init__(cfg, setup)
        p = cfg['pme']
        self.order, self.ewald = int(p['order']), float(p['alpha'])
        self.coulomb, self.cutoff = float(p['coulomb']), float(p['cutoff'])
        self.charges = setup.charges.float()
        self.grid = setup.pme_grid
        dev = self.device
        b = [torch.as_tensor(euler_factors(g, self.order), device=dev)
             for g in self.grid]
        freq = [torch.as_tensor(np.fft.fftfreq(g, 1.0 / g), device=dev)
                / self.lengths[k].double() for k, g in enumerate(self.grid)]
        m2 = (freq[0][:, None, None] ** 2 + freq[1][None, :, None] ** 2
              + freq[2][None, None, :] ** 2)
        volume = float(torch.prod(self.lengths.double()))
        factor = torch.exp(-(math.pi ** 2 / self.ewald ** 2) * m2) / torch.where(
            m2 > 0, m2, 1.0)
        factor = factor * b[0][:, None, None] * b[1][None, :, None] \
            * b[2][None, None, :]
        factor[0, 0, 0] = 0.0
        self.factor = (self.coulomb / (2.0 * math.pi * volume) * factor).float()
        self.self_term = float(-self.coulomb * self.ewald / math.sqrt(math.pi)
                               * torch.sum(self.charges.double() ** 2))

    def _reciprocal(self, pos: Tensor, dt: torch.dtype) -> Tensor:
        grid = torch.tensor(self.grid, device=pos.device)
        frac = pos / self.lengths
        u = (frac - torch.floor(frac.detach())) * grid       # in [0, K)
        base = torch.floor(u.detach()).long()
        w = (u - base).to(dt)                                 # [N, 3]
        k = torch.arange(self.order, device=pos.device)
        # Grid point base - k takes M_n(w + k).
        m = bspline_pieces(w, self.order)                     # [N, 3, n]
        idx = (base[:, :, None] - k) % grid[None, :, None]
        q = self.charges.to(dt)
        stencil = (q[:, None, None, None] * m[:, 0, :, None, None]
                   * m[:, 1, None, :, None] * m[:, 2, None, None, :])
        gy, gz = self.grid[1], self.grid[2]
        flat = ((idx[:, 0, :, None, None] * gy + idx[:, 1, None, :, None]) * gz
                + idx[:, 2, None, None, :])
        total = int(np.prod(self.grid))
        mesh = torch.zeros(total, dtype=dt, device=pos.device).index_add(
            0, flat.reshape(-1), stencil.reshape(-1))
        fq = torch.fft.fftn(mesh.float().reshape(self.grid))
        return torch.sum(self.factor * (fq.real ** 2 + fq.imag ** 2))

    def _direct(self, pos: Tensor, pairs, dt: torch.dtype) -> Tensor:
        i, j, r = pairs
        keep = (i < j) & (r < self.cutoff)
        i, j = i[keep], j[keep]
        d = ani2x_window.minimum_image(pos[j] - pos[i], self.lengths).to(dt)
        dist = torch.sqrt(torch.sum(d * d, -1))
        q = self.charges.to(dt)
        return self.coulomb * torch.sum(
            (q[i] * q[j] * torch.erfc(self.ewald * dist) / dist).float())

    def extra_energy_and_grad(self, pos: Tensor, pairs, control: bool):
        dt = torch.bfloat16 if control else torch.float32
        e = self._direct(pos, pairs, dt) + self._reciprocal(pos, dt)
        (g,) = torch.autograd.grad(e, pos)
        return float(e.detach()) + self.self_term, g

    @torch.no_grad()
    def work_counts(self, positions: Tensor) -> dict:
        out = super().work_counts(positions)
        i, j, r = ani2x_window.pairs_within(positions, self.lengths,
                                            self.cutoff)
        out['pme_pairs'] = int(torch.sum(i < j))
        out['pme_atoms'] = int(positions.shape[0])
        out['pme_grid'] = list(self.grid)
        out['pme_order'] = self.order
        return out

    def work(self, cfg: dict, counts: dict) -> dict:
        return work.add(work.ani_work(cfg, counts), work.pme_work(counts))


def make(cfg: dict, setup) -> Reference:
    return Reference(cfg, setup)
