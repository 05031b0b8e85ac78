"""The plain reference of the ``schnet_cell_list`` kind: SchNet energy and
forces on a periodic box.

SchNet (Schutt et al., J. Chem. Phys. 148, 241722, 2018) as SchNetPack
builds it: its ``SchNet`` representation of ``SchNetInteraction`` blocks
and an ``Atomwise`` readout summed over the atoms,

    x = embedding[species]
    per interaction:  v = x W_in2f                          (no bias)
                      W_ij = (ssp(rbf(d_ij) W1 + b1) W2 + b2) fc(d_ij)
                      m_i = sum over j with d_ij < rc of W_ij * v_j
                      x = x + ssp(m W_f2out + b_f2out) W_dense + b_dense
    E = sum_i ssp(x_i R1 + r1) R2 + r2

with ``rbf`` SchNetPack's ``GaussianRBF``, exp(-(d - mu_k)^2 / (2
sigma^2)) on mu = linspace(0, rc, G), sigma = rc / (G - 1);
``CosineCutoff`` fc(d) = 0.5 (cos(pi d / rc) + 1) below rc; ssp(x) =
softplus(x) - ln 2. Neighbors by brute-force minimum image within rc
(``md.PairList``), float32 with TF32 off, forces by autograd. Each
(interaction, row block) runs under ``torch.utils.checkpoint`` and is
computed again in the backward, so only the [N, W] features are kept.

Departures from SchNetPack: the parameters are random (``schnet_params``),
not trained; the embedding is indexed by the configuration's element order
rather than by atomic number; the readout has no standardisation (mean and
scale) and no atom reference energies.

``control=True`` rounds the operands of the two filter products (rbf W1
and ssp(.) W2) to bfloat16, float32 accumulation: the precision one step
below the configuration's.

Plain PyTorch: it imports nothing of the program and takes none of its
layouts, selections or capacities.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from mdbench import schnet_params
from mdbench.reference.ani2x_window import (_Round, no_tf32,
                                            species_index)
from mdbench.reference.md import (PairList, box_lengths, minimum_image,
                                  pairs_within)

Tensor = torch.Tensor
ROW_BLOCK = 2048
LN2 = math.log(2.0)


def ssp(x: Tensor) -> Tensor:
    return torch.nn.functional.softplus(x) - LN2


def cfconv_work(counts: dict) -> dict:
    """Work classes of one force evaluation (``work.py``'s classes), per
    directed pair inside rc and per atom, every layer: the filter's two
    products and their input-side adjoints (d_act, d_rbf), and the atomwise
    layers forward and input gradient, as bf16 tensor FLOP (an FMA two);
    per pair the message, its input-gradient row and the cutoff's
    cotangent, one FP32 FMA a feature each; the forward's Gaussians,
    softplus and cosine as special-function operations; bytes: positions,
    species and parameters read once, forces and the energy written
    once."""
    p, n = counts['cfconv_pairs'], counts['atoms']
    layers, w, g = counts['interactions'], counts['width'], counts['gaussians']
    half = w // 2
    per_layer = p * 2 * 2 * (g * w + w * w) + n * 2 * 2 * 3 * w * w
    params = (counts['species'] * w + layers * (g * w + 3 * w * w + 4 * w)
              + w * half + half + half + 1)
    return {'tensor_bf16': layers * per_layer + n * 2 * 2 * (w * half + half),
            'fp32': layers * p * 3 * 2 * w,
            'sfu': layers * p * (g + w + 1),
            'bytes': 4 * params + n * (12 + 4 + 12) + 4}


class Reference:
    """SchNet on one box: ``energy_forces_and_ani(positions)``."""

    def __init__(self, cfg: dict, setup):
        self.device = setup.device
        self.params = schnet_params.make(cfg, setup.weights, setup.device)
        self.rc = float(cfg['cutoff'])
        self.width = int(cfg['width'])
        self.num_gaussians = int(cfg['gaussians'])
        self.interactions = int(cfg['interactions'])
        self.num_species = len(cfg['elements'])
        self.species = torch.as_tensor(
            species_index(setup.atomic_numbers, cfg['elements']),
            device=self.device)
        self.lengths = box_lengths(setup.box)
        self.pair_list = PairList(self.lengths, self.rc)
        self.centers = torch.linspace(0.0, self.rc, self.num_gaussians,
                                      device=self.device)
        self.sigma = self.rc / (self.num_gaussians - 1)

    def _conv_rows(self, pos: Tensor, v: Tensor, i: Tensor, j: Tensor,
                   r0: int, rows: int, block: schnet_params.Block,
                   control: bool) -> Tensor:
        """m_i of rows r0 .. r0 + rows from their pairs (i, j)."""
        rnd = ((lambda t: _Round.apply(t, torch.bfloat16)) if control
               else (lambda t: t))
        d = minimum_image(pos[j] - pos[i], self.lengths)
        r = torch.sqrt(torch.sum(d * d, -1))
        rbf = torch.exp(-0.5 * ((r[:, None] - self.centers) / self.sigma)
                        ** 2)
        h = ssp(rnd(rbf) @ rnd(block.w1) + block.b1)
        fc = 0.5 * (torch.cos(r * (math.pi / self.rc)) + 1.0)
        filt = (rnd(h) @ rnd(block.w2) + block.b2) * fc[:, None]
        return torch.zeros(rows, v.shape[1], dtype=v.dtype,
                           device=v.device).index_add(0, i - r0,
                                                      filt * v[j])

    def energy_forces_and_ani(self, positions: Tensor, control=False):
        """(energy [] float64, forces [N, 3] float32, None) at
        ``positions``; ``control``: the filter products' operands in
        bfloat16."""
        n = positions.shape[0]
        i, j, _ = self.pair_list(positions.detach())
        starts = torch.searchsorted(
            i, torch.arange(0, n + ROW_BLOCK, ROW_BLOCK,
                            device=i.device).clamp_(max=n)).tolist()
        p = self.params
        pos = positions.detach().float().requires_grad_(True)
        with no_tf32(), torch.enable_grad():
            x = p.embedding.index_select(0, self.species)
            for block in p.blocks:
                v = x @ block.in2f
                m = torch.cat([
                    checkpoint(self._conv_rows, pos, v, i[a:b], j[a:b], r0,
                               min(n, r0 + ROW_BLOCK) - r0, block,
                               bool(control), use_reentrant=False)
                    for r0, a, b in zip(range(0, n, ROW_BLOCK), starts,
                                        starts[1:])])
                x = x + ssp(m @ block.f2out_w + block.f2out_b) \
                    @ block.dense_w + block.dense_b
            e_atoms = ssp(x @ p.readout1_w + p.readout1_b) @ p.readout2_w \
                + p.readout2_b
            energy = torch.sum(e_atoms.double())
            (grad,) = torch.autograd.grad(energy, pos)
        return energy.detach(), -grad.detach(), None

    # ---- Work.

    @torch.no_grad()
    def work_counts(self, positions: Tensor) -> dict:
        """The interactions a force evaluation needs at ``positions``: the
        directed pairs inside rc and the atoms, with the shapes they are
        counted at (interactions, width, Gaussians, species)."""
        i, _, _ = pairs_within(positions, self.lengths, self.rc)
        return {'cfconv_pairs': int(i.numel()),
                'atoms': int(positions.shape[0]),
                'interactions': self.interactions, 'width': self.width,
                'gaussians': self.num_gaussians,
                'species': self.num_species}

    def work(self, cfg: dict, counts: dict) -> dict:
        """The essential work of one force evaluation (``work.py``'s
        classes)."""
        return cfconv_work(counts)


def make(cfg: dict, setup) -> Reference:
    return Reference(cfg, setup)
