"""The plain reference of the ``painn_cell_list`` kind: PaiNN energy and
forces on a periodic box.

PaiNN (Schütt, Unke and Gastegger, ICML 2021, arXiv:2102.03150) as
SchNetPack's ``PaiNN`` representation builds it, with an ``Atomwise``
readout summed over the atoms. With r_ij = R_j - R_i under the minimum
image, d = |r_ij|, u = r_ij / d, s = embedding[species], v = 0 [3, F]:

    per block:  phi = SiLU(s Phi1 + p1) Phi2 + p2                [3F]
                W_ij = (rbf(d) Wf + bf) fc(d),  rbf_n = sin(n pi d / rc) / d
                (x_s, x_vv, x_vs) = phi_j * W_ij
                s_i += sum_j x_s,   v_i += sum_j (v_j * x_vv + u_ij (x) x_vs)
                (Uv, Vv) = v (U | V)                              (no bias)
                (a_vv, a_sv, a_ss) = SiLU([s, sqrt(sum_c Vv^2 + 1e-8)] A1
                                          + c1) A2 + c2
                v += a_vv * Uv,   s += a_sv * sum_c Uv . Vv + a_ss
    E = sum_i SiLU(s_i R1 + r1) R2 + r2

with n = 1 .. R, ``CosineCutoff`` fc(d) = 0.5 (cos(pi d / rc) + 1) below
rc, sums over every j with d < rc. Neighbors by brute-force minimum image
within rc (``md.PairList``), float32 with TF32 off, the energy summed in
float64, forces by autograd. Each (block, row block) message is an
``index_add`` under ``torch.utils.checkpoint``, computed again in the
backward, so only the per-atom states are kept.

Departures from SchNetPack: the parameters are random (``painn_params``),
not trained; the embedding is indexed by the configuration's element order
rather than by atomic number; each block has its own filter layer R -> 3F
(SchNetPack's one layer R -> 3F x blocks, split by block, is the same map);
the splits are in the order above (SchNetPack's (x_s, x_vs, x_vv), (a_ss,
a_vv, a_sv) and (Vv, Uv): a permutation of random columns); the readout
has no standardisation and no atom reference energies.

``control=True`` rounds the operands of the filter product (rbf Wf) and of
phi's two dense layers to bfloat16, float32 accumulation: the precision one
step below the configuration's.

Plain PyTorch: it imports nothing of the program and takes none of its
layouts, selections or capacities.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from mdbench import painn_params
from mdbench.reference.ani2x_window import _Round, no_tf32, species_index
from mdbench.reference.md import (PairList, box_lengths, minimum_image,
                                  pairs_within)

Tensor = torch.Tensor
ROW_BLOCK = 2048
NORM_EPS = 1e-8

# FP32 operations (an FMA two) a directed pair inside rc needs in one
# block, per feature F: forward 22 (the filter's bias and cutoff 2 x 3F,
# phi_j * W 3F, x_s into m_s F, the two vector terms 2 x 3F FMA);
# backward 46: the lane's 30 (the (v_j, g_v) and (u, g_v) contractions
# 2 x 3F FMA, dW 3F, dW * fc 3F, the cutoff's cotangent 3F FMA, d u 3F
# FMA) and its mirrored entry's d phi 16 (W_s g_s F FMA, W_vv g_v 3F FMA,
# (u, g_v) 3F FMA, W_vs times it F FMA); and 4 per radial function (d d
# from the rbf cotangent).
PAIR_FWD_PER_F, PAIR_BWD_PER_F, PAIR_BWD_PER_R = 22, 46, 4


def silu(x: Tensor) -> Tensor:
    return torch.nn.functional.silu(x)


def painn_work(counts: dict) -> dict:
    """Work classes of one force evaluation (``work.py``'s classes), per
    directed pair inside rc and per atom, every block: the filter product
    (R x 3F) and its input-side adjoint, and the atomwise layers (phi F x
    F and F x 3F, U | V 3 x F x 2F, the update's 2F x F and F x 3F, the
    readout), forward and input gradient, as bf16 tensor FLOP (an FMA two);
    per pair the message's FP32 work above (``PAIR_*``); its sines, the
    cutoff's cosine and the length's sqrt forward, the cosines and the
    cutoff's sine backward, as special-function operations. The per-atom
    elementwise work (SiLU, the norm, the update's products) is left out:
    under 0.1 % of the pairs'. Bytes: positions, species and parameters
    read once, forces and the energy written once."""
    p, n = counts['painn_pairs'], counts['atoms']
    blocks, f, r = counts['interactions'], counts['width'], counts['radial']
    half = f // 2
    atom_macs = f * f + f * 3 * f + 3 * f * 2 * f + 2 * f * f + f * 3 * f
    per_block = p * 2 * 2 * r * 3 * f + n * 2 * 2 * atom_macs
    params = (counts['species'] * f
              + blocks * (f * f + f + f * 3 * f + 3 * f + r * 3 * f + 3 * f
                          + f * 2 * f + 2 * f * f + f + f * 3 * f + 3 * f)
              + f * half + half + half + 1)
    return {'tensor_bf16': blocks * per_block + n * 2 * 2 * (f * half + half),
            'fp32': blocks * p * ((PAIR_FWD_PER_F + PAIR_BWD_PER_F) * f
                                  + PAIR_BWD_PER_R * r),
            'sfu': blocks * p * (2 * r + 3),
            'bytes': 4 * params + n * (12 + 4 + 12) + 4}


class Reference:
    """PaiNN on one box: ``energy_forces_and_ani(positions)``."""

    def __init__(self, cfg: dict, setup):
        self.device = setup.device
        self.params = painn_params.make(cfg, setup.weights, setup.device)
        self.rc = float(cfg['cutoff'])
        self.width = int(cfg['width'])
        self.radial = int(cfg['radial'])
        self.interactions = int(cfg['interactions'])
        self.num_species = len(cfg['elements'])
        self.species = torch.as_tensor(
            species_index(setup.atomic_numbers, cfg['elements']),
            device=self.device)
        self.lengths = box_lengths(setup.box)
        self.pair_list = PairList(self.lengths, self.rc)
        self.freq = torch.arange(1, self.radial + 1, dtype=torch.float32,
                                 device=self.device) * (math.pi / self.rc)

    def _message_rows(self, pos: Tensor, phi: Tensor, v: Tensor, i: Tensor,
                      j: Tensor, r0: int, rows: int,
                      block: painn_params.Block, control: bool):
        """(m_s, m_v) of rows r0 .. r0 + rows from their pairs (i, j)."""
        rnd = ((lambda t: _Round.apply(t, torch.bfloat16)) if control
               else (lambda t: t))
        f = self.width
        d = minimum_image(pos[j] - pos[i], self.lengths)
        r = torch.sqrt(torch.sum(d * d, -1))
        u = d / r[:, None]
        rbf = torch.sin(r[:, None] * self.freq) / r[:, None]
        fc = 0.5 * (torch.cos(r * (math.pi / self.rc)) + 1.0)
        w = (rnd(rbf) @ rnd(block.filter_w) + block.filter_b) * fc[:, None]
        xs, xvv, xvs = (phi[j] * w).split(f, -1)
        ms = torch.zeros(rows, f, dtype=phi.dtype,
                         device=phi.device).index_add(0, i - r0, xs)
        mv = torch.zeros(rows, 3, f, dtype=phi.dtype,
                         device=phi.device).index_add(
            0, i - r0, v[j] * xvv[:, None, :] + u[:, :, None] * xvs[:, None, :])
        return ms, mv

    def energy_forces_and_ani(self, positions: Tensor, control=False):
        """(energy [] float64, forces [N, 3] float32, None) at
        ``positions``; ``control``: the filter product's and phi's
        operands in bfloat16."""
        n, f = positions.shape[0], self.width
        i, j, _ = self.pair_list(positions.detach())
        starts = torch.searchsorted(
            i, torch.arange(0, n + ROW_BLOCK, ROW_BLOCK,
                            device=i.device).clamp_(max=n)).tolist()
        rnd = ((lambda t: _Round.apply(t, torch.bfloat16)) if control
               else (lambda t: t))
        p = self.params
        pos = positions.detach().float().requires_grad_(True)
        with no_tf32(), torch.enable_grad():
            s = p.embedding.index_select(0, self.species)
            v = s.new_zeros(n, 3, f)
            for block in p.blocks:
                phi = rnd(silu(rnd(s) @ rnd(block.phi1_w) + block.phi1_b)) \
                    @ rnd(block.phi2_w) + block.phi2_b
                parts = [
                    checkpoint(self._message_rows, pos, phi, v, i[a:b],
                               j[a:b], r0, min(n, r0 + ROW_BLOCK) - r0, block,
                               bool(control), use_reentrant=False)
                    for r0, a, b in zip(range(0, n, ROW_BLOCK), starts,
                                        starts[1:])]
                s = s + torch.cat([m for m, _ in parts])
                v = v + torch.cat([m for _, m in parts])
                uv, vv = (v @ block.uv).split(f, -1)
                norm = torch.sqrt(torch.sum(vv * vv, 1) + NORM_EPS)
                a_vv, a_sv, a_ss = (silu(torch.cat([s, norm], -1)
                                         @ block.a1_w + block.a1_b)
                                    @ block.a2_w + block.a2_b).split(f, -1)
                s = s + a_sv * torch.sum(uv * vv, 1) + a_ss
                v = v + a_vv[:, None, :] * uv
            e_atoms = silu(s @ p.readout1_w + p.readout1_b) @ p.readout2_w \
                + p.readout2_b
            energy = torch.sum(e_atoms.double())
            (grad,) = torch.autograd.grad(energy, pos)
        return energy.detach(), -grad.detach(), None

    # ---- Work.

    @torch.no_grad()
    def work_counts(self, positions: Tensor) -> dict:
        """The interactions a force evaluation needs at ``positions``: the
        directed pairs inside rc and the atoms, with the shapes they are
        counted at (blocks, width, radial functions, species)."""
        i, _, _ = pairs_within(positions, self.lengths, self.rc)
        return {'painn_pairs': int(i.numel()),
                'atoms': int(positions.shape[0]),
                'interactions': self.interactions, 'width': self.width,
                'radial': self.radial, 'species': self.num_species}

    def work(self, cfg: dict, counts: dict) -> dict:
        """The essential work of one force evaluation (``work.py``'s
        classes)."""
        return painn_work(counts)


def make(cfg: dict, setup) -> Reference:
    return Reference(cfg, setup)
