"""The plain reference of the ``ani2x_window`` kind: ANI-2x energy and
forces on a periodic box.

Brute-force minimum-image neighbor search (through a Verlet list), the
AEV from the published constants as TorchANI computes it (radial ``0.25
exp(-EtaR (r - ShfR)^2) fc(r)`` summed per neighbor species; angular ``2
((1 + cos(theta - ShfZ)) / 2)^Zeta exp(-EtaA ((r1 + r2) / 2 - ShfA)^2)
fc(r1) fc(r2)`` with theta = acos(0.95 cos) summed per unordered species
pair), each species' 8-model
network with CELU(0.1) in float32 with TF32 off, the model mean plus the
self energies, and forces by autograd. Rows go in blocks, each block's
energy differentiated on its own, so the angular triples fit in memory.

``control=True`` computes the same in the precision one step below the
configuration's: the AEV's arithmetic in bfloat16 (from float32
displacements) and the ensemble's matmul operands rounded to float8 e4m3;
``control='ensemble'`` lowers the ensemble's operands alone.

Plain PyTorch: it imports nothing of the program and takes none of its
layouts, selections or capacities.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from mdbench import work
from mdbench.reference.md import (PairList, box_lengths, dense_table,
                                  minimum_image, pairs_within)

Tensor = torch.Tensor
ROW_BLOCK = 8192


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls in float32 (TF32 off) inside the block, restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class _Round(torch.autograd.Function):
    """``x`` rounded to ``dtype`` and back, gradient passed unchanged."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def species_index(atomic_numbers, elements) -> np.ndarray:
    table = {int(z): i for i, z in enumerate(elements)}
    return np.array([table[int(z)] for z in atomic_numbers], np.int64)


def pair_table(num_species: int) -> np.ndarray:
    """Unordered species pair -> index, (0,0), (0,1), ..., (1,1), ..."""
    t = np.zeros((num_species, num_species), np.int64)
    k = 0
    for a in range(num_species):
        for b in range(a, num_species):
            t[a, b] = t[b, a] = k
            k += 1
    return t


def cosine_cutoff(r: Tensor, rc: float) -> Tensor:
    return 0.5 * torch.cos(r * (math.pi / rc)) + 0.5


class Reference:
    """ANI-2x on one box: ``energy_and_forces(positions)``."""

    def __init__(self, cfg: dict, setup):
        a = cfg['aev']
        dev = setup.device
        self.device = dev
        self.rcr, self.rca = float(a['Rcr']), float(a['Rca'])
        self.num_species = int(cfg['species'])
        self.species = torch.as_tensor(
            species_index(setup.atomic_numbers, cfg['elements']), device=dev)
        self.lengths = box_lengths(setup.box)
        self.pair_list = PairList(self.lengths, self.rcr)
        c = lambda key: torch.tensor(a[key], dtype=torch.float32, device=dev)  # noqa: E731
        self.eta_r, self.shf_r = c('EtaR'), c('ShfR')
        self.eta_a, self.zeta, self.shf_a, self.shf_z = (
            c('EtaA'), c('Zeta'), c('ShfA'), c('ShfZ'))
        self.radial_scale = float(a['radial_scale'])
        self.angle_scale = float(a['angle_scale'])
        self.pairs = torch.as_tensor(pair_table(self.num_species), device=dev)
        self.num_pairs = self.num_species * (self.num_species + 1) // 2
        self.nets = setup.weights
        self.alpha = float(cfg['celu_alpha'])
        self.self_energy = float(torch.sum(torch.tensor(
            cfg['self_energies'], dtype=torch.float64)[self.species.cpu()]))

    # ---- AEV.

    def _aev(self, pos: Tensor, rows: Tensor, rad: Tensor, ang: Tensor,
             dt: torch.dtype) -> Tensor:
        """[len(rows), S*R + P*A] AEV rows, differentiable in ``pos``:
        every radial pair and angular triple of the rows, summed into
        (row, species) and (row, species pair) slots."""
        s, b = self.num_species, rows.shape[0]
        # Radial: every neighbor inside Rcr.
        ii, kk = (rad[rows] >= 0).nonzero(as_tuple=True)
        j = rad[rows][ii, kk]
        d = minimum_image(pos[j] - pos[rows[ii]], self.lengths).to(dt)
        r = torch.sqrt(torch.sum(d * d, -1))
        terms = (self.radial_scale * torch.exp(
            -self.eta_r.to(dt) * (r[:, None] - self.shf_r.to(dt)) ** 2)
            * cosine_cutoff(r, self.rcr)[:, None])
        radial = torch.zeros(b * s, terms.shape[1], dtype=dt,
                             device=pos.device).index_add(
            0, ii * s + self.species[j], terms)
        # Angular: every unordered pair of neighbors inside Rca.
        tab = ang[rows]
        width = tab.shape[1]
        p, q = torch.triu_indices(width, width, 1, device=pos.device)
        ok = (tab[:, p] >= 0) & (tab[:, q] >= 0)
        ii, tt = ok.nonzero(as_tuple=True)
        j, k = tab[ii, p[tt]], tab[ii, q[tt]]
        center = pos[rows[ii]]
        d1 = minimum_image(pos[j] - center, self.lengths).to(dt)
        d2 = minimum_image(pos[k] - center, self.lengths).to(dt)
        r1 = torch.sqrt(torch.sum(d1 * d1, -1))
        r2 = torch.sqrt(torch.sum(d2 * d2, -1))
        theta = torch.acos(self.angle_scale * torch.sum(d1 * d2, -1)
                           / (r1 * r2))
        f1 = (0.5 * (1.0 + torch.cos(theta[:, None] - self.shf_z.to(dt)))
              ) ** self.zeta.to(dt)
        f2 = torch.exp(-self.eta_a.to(dt) * (0.5 * (r1 + r2)[:, None]
                                             - self.shf_a.to(dt)) ** 2)
        fc = cosine_cutoff(r1, self.rca) * cosine_cutoff(r2, self.rca)
        terms = (2.0 * f2[:, :, None] * f1[:, None, :]
                 * fc[:, None, None]).flatten(1)
        slot = ii * self.num_pairs + self.pairs[self.species[j],
                                                self.species[k]]
        angular = torch.zeros(b * self.num_pairs, terms.shape[1], dtype=dt,
                              device=pos.device).index_add(0, slot, terms)
        return torch.cat([radial.reshape(b, -1), angular.reshape(b, -1)],
                         1).float()

    # ---- Ensemble.

    def _atom_energies(self, x: Tensor, species: Tensor,
                       control: bool) -> Tensor:
        """Model-mean network energies of rows ``x`` [n, aev]."""
        out = x.new_zeros(x.shape[0])
        rnd = (lambda t: _Round.apply(t, torch.float8_e4m3fn)) if control \
            else (lambda t: t)
        for s in torch.unique(species).tolist():
            rows = (species == s).nonzero(as_tuple=True)[0]
            h = x[rows][None]
            net = self.nets[s]
            last = len(net.weights) - 1
            for l, (w, b) in enumerate(zip(net.weights, net.biases)):
                h = torch.matmul(rnd(h), rnd(w).transpose(1, 2)) + b[:, None, :]
                if l < last:
                    h = torch.nn.functional.celu(h, alpha=self.alpha)
            out = out.index_add(0, rows, h[:, :, 0].mean(0))
        return out

    # ---- Energy and forces.

    def neighbor_tables(self, pos: Tensor):
        n = pos.shape[0]
        i, j, r = self.pair_list(pos.detach())
        a = r < self.rca
        return (dense_table(i, j, n), dense_table(i[a], j[a], n), (i, j, r))

    def energy_and_forces(self, positions: Tensor, control=False):
        """(energy [] float64, forces [N, 3] float32) at ``positions``."""
        return self.energy_forces_and_ani(positions, control)[:2]

    def energy_forces_and_ani(self, positions: Tensor, control=False):
        """(energy, forces, the ANI part of the forces) at ``positions``.
        ``control``: False, the configuration's precision; True, every
        part one step below; 'ensemble', only the ensemble's operands."""
        n = positions.shape[0]
        rad, ang, pairs = self.neighbor_tables(positions)
        low = control is True
        dt = torch.bfloat16 if low else torch.float32
        pos = positions.detach().float().requires_grad_(True)
        grad = torch.zeros_like(pos)
        energy = self.self_energy
        with no_tf32(), torch.enable_grad():
            for r0 in range(0, n, ROW_BLOCK):
                rows = torch.arange(r0, min(n, r0 + ROW_BLOCK),
                                    device=pos.device)
                aev = self._aev(pos, rows, rad, ang, dt)
                e = torch.sum(self._atom_energies(aev, self.species[rows],
                                                  bool(control)))
                (g,) = torch.autograd.grad(e, pos)
                grad += g
                energy += float(e.detach())
            e_x, g_x = self.extra_energy_and_grad(pos, pairs, low)
        return (torch.tensor(energy + e_x, dtype=torch.float64),
                -(grad + g_x).detach(), -grad.detach())

    def extra_energy_and_grad(self, pos: Tensor, pairs, control: bool):
        """Terms beside ANI (none here): (energy, gradient)."""
        return 0.0, torch.zeros_like(pos)

    # ---- Work.

    @torch.no_grad()
    def work_counts(self, positions: Tensor) -> dict:
        """The interactions the force evaluation needs at ``positions``:
        directed radial pairs inside Rcr, angular triples (a center and an
        unordered pair of its neighbors inside Rca), atoms per species."""
        n = positions.shape[0]
        i, _, r = pairs_within(positions, self.lengths, self.rcr)
        per_atom = torch.bincount(i[r < self.rca], minlength=n)
        return {'radial_pairs': int(i.numel()),
                'angular_triples': int(torch.sum(per_atom * (per_atom - 1)
                                                 // 2)),
                'atoms_per_species': torch.bincount(
                    self.species, minlength=self.num_species).tolist()}


    def work(self, cfg: dict, counts: dict) -> dict:
        """The essential work of one force evaluation (``work.py``)."""
        return work.ani_work(cfg, counts)


def make(cfg: dict, setup) -> Reference:
    return Reference(cfg, setup)
