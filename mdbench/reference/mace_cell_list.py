"""The plain reference of the ``mace_cell_list`` kind: MACE energy and
forces on a periodic box.

MACE (Batatia et al., NeurIPS 2022, arXiv:2206.07697) as ACEsuit/mace's
``ScaleShiftMACE`` builds it (scale 1, shift 0, every E0 0), with
``RealAgnosticResidualInteractionBlock`` in both layers. With r_ij = R_j -
R_i under the minimum image, d = |r_ij|, r^ = r_ij / d, F channels, E
elements, SiLU_n = SiLU x 1 / sqrt(E[SiLU(z)^2]), z ~ N(0, 1):

    Y(r^)    real harmonics l = 0 .. 3, m = -l .. l, no Condon-Shortley
             phase, sum_m Y_lm^2 = 2l + 1
    e_n(d) = sqrt(2/rc) sin(n pi d/rc)/d (1 - 21 x^5 + 35 x^6 - 15 x^7),
             x = d/rc, n = 1 .. R
    R(d)   = MLP(e): x W / sqrt(fan-in), SiLU_n between, no biases
    h^0    = W_emb[z] / sqrt(E)                                   (0e)
    per layer t:
      sc   = h_0e W_sc[z] / sqrt(F E)
      h~_l = h_l W_up,l / sqrt(F)
      m_i^p[k, m3] = sum_j R_p,k(d) sum C^{l1 l2 l3}_{m1 m2 m3} h~_j[k, l1 m1]
                     Y_l2 m2(r^_ij)     for the paths (l1, l2 -> l3),
                     l1 of h~, l3 <= 3, parity-allowed, e3nn's order
      A_l3 = sum_{p -> l3} m^p W_mid,p / sqrt(P_l3 F) / avg_num_neighbors
      B[k, LM] = sum_{nu = 1..3} sum_{m1..m_nu} (sum_eta U^{nu,L}_eta
                 W_nu,L[z, eta, k]) prod_xi A[k, m_xi]
      h_L = B_L W_L / sqrt(F) (+ sc on 0e)
    E = sum_i (sum_{t < last} h^t_0e w / sqrt(F)
               + SiLU_n(h^last_0e W1 + b1) W2 + b2)

with C the real Wigner 3j times sqrt(2 l3 + 1) and U^{nu,L} the
orthonormal basis of the slot-symmetric equivariant tensors (R^16)^{(x)
nu} -> L of output parity (-1)^L. This file builds its own tables: Y from
the associated Legendre functions, the 3j symbols from Racah's formula for
the complex Clebsch-Gordan coefficients turned into the real basis
(made real by a global phase, unit norm, the first entry of magnitude
over 1e-6 positive), U from the coupling trees ((l1 (x) l2)_l12 (x) l3)
-> L through C, symmetrised over the slots, and Gram-Schmidt in the tree
order (nu = 2: l1, l2 over 0 .. 3; nu = 3: l1, l2, l3, then l12
innermost), a residual under 1e-9 dropped.

Neighbors by brute-force minimum image within rc (``md.PairList``),
float32 with TF32 off, the energy summed in float64, forces by autograd.
Each (layer, row block) message is an ``index_add`` over the pairs under
``torch.utils.checkpoint``; the contraction of each atom block takes
A's slots one at a time (first slot first) by autograd, under checkpoint
too.

Departures from mace: the parameters are random (``mace_params``); U is
an orthonormal basis of the space mace's ``U_matrix_real`` spans, the
harmonics' basis and the 3j signs are this file's (each a fixed
orthogonal change of a random weight's basis); species-indexed weights
follow the configuration's element order.

``control=True`` rounds the operands of the radial MLPs' products and of
the ``up`` linears to bfloat16, float32 accumulation: the precision one
step below the configuration's.

Plain PyTorch: it imports nothing of the program and takes none of its
layouts, selections or capacities.
"""
from __future__ import annotations

import functools
import itertools
import math
from fractions import Fraction

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mdbench import mace_params
from mdbench.reference.ani2x_window import _Round, no_tf32, species_index
from mdbench.reference.md import (PairList, box_lengths, minimum_image,
                                  pairs_within)

Tensor = torch.Tensor
ROW_BLOCK = 2048
ATOM_BLOCK = 512
LMAX = 3
DIM = 16


def block(l):
    return slice(l * l, (l + 1) * (l + 1))


# ---- Harmonics.


def _legendre_coefficients(l: int, m: int):
    """Exact coefficients, by power of z, of d^m P_l / dz^m (Rodrigues:
    P_l = 2^-l sum_k (-1)^k C(l, k) C(2l - 2k, l) z^(l - 2k))."""
    c = {}
    for k in range(l // 2 + 1):
        c[l - 2 * k] = Fraction((-1) ** k * math.comb(l, k)
                                * math.comb(2 * l - 2 * k, l), 2 ** l)
    for _ in range(m):
        c = {p - 1: v * p for p, v in c.items() if p > 0}
    return c


def harmonics(u: Tensor) -> Tensor:
    """[..., 16] the real harmonics l = 0 .. 3 of unit vectors ``u``."""
    x, y, z = u.unbind(-1)
    re, im = [torch.ones_like(x)], [torch.zeros_like(x)]
    for _ in range(LMAX):          # (x + iy)^m, m = 0 .. 3
        re, im = re + [re[-1] * x - im[-1] * y], im + [im[-1] * x
                                                       + re[-1] * y]
    out = []
    for l in range(LMAX + 1):
        for m in range(-l, l + 1):
            a = abs(m)
            norm = math.sqrt((2 * l + 1) * (2 if a else 1)
                             * math.factorial(l - a) / math.factorial(l + a))
            q = sum(float(v) * z ** p for p, v in
                    _legendre_coefficients(l, a).items())
            out.append(norm * q * (re[a] if m >= 0 else im[a]))
    return torch.stack(out, -1)


# ---- Clebsch-Gordan coefficients and the contraction's bases.


def _cg_complex(j1, m1, j2, m2, j3, m3) -> float:
    """<j1 m1 j2 m2 | j3 m3> by Racah's formula."""
    if m1 + m2 != m3 or not abs(j1 - j2) <= j3 <= j1 + j2 or \
            abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    f = math.factorial
    pre = ((2 * j3 + 1) * f(j3 + j1 - j2) * f(j3 - j1 + j2) * f(j1 + j2 - j3)
           / f(j1 + j2 + j3 + 1))
    pre *= (f(j3 + m3) * f(j3 - m3) * f(j1 - m1) * f(j1 + m1) * f(j2 - m2)
            * f(j2 + m2))
    total = 0.0
    for k in range(0, j1 + j2 - j3 + 1):
        args = (k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k,
                j3 - j2 + m1 + k, j3 - j1 - m2 + k)
        if min(args) < 0:
            continue
        total += (-1) ** k / math.prod(f(a) for a in args)
    return math.sqrt(pre) * total


def _to_real(l: int) -> np.ndarray:
    """A [2l + 1, 2l + 1]: real harmonics = A complex harmonics (with the
    Condon-Shortley phase), rows m = -l .. l, columns mu = -l .. l."""
    a = np.zeros((2 * l + 1, 2 * l + 1), complex)
    s = 1 / math.sqrt(2)
    for m in range(-l, l + 1):
        if m > 0:
            a[l + m, l - m] = s
            a[l + m, l + m] = (-1) ** m * s
        elif m < 0:
            a[l + m, l + m] = 1j * s
            a[l + m, l - m] = -1j * (-1) ** m * s
        else:
            a[l, l] = 1.0
    return a


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """The real 3j symbol times sqrt(2 l3 + 1), float64."""
    shape = (2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1)
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        return np.zeros(shape)
    cg = np.zeros(shape)
    for m1, m2 in itertools.product(range(-l1, l1 + 1), range(-l2, l2 + 1)):
        if abs(m1 + m2) <= l3:
            cg[l1 + m1, l2 + m2, l3 + m1 + m2] = _cg_complex(
                l1, m1, l2, m2, l3, m1 + m2)
    a1, a2, a3 = _to_real(l1), _to_real(l2), _to_real(l3)
    c = np.einsum('cz,xyz,ax,by->abc', a3, cg, a1.conj(), a2.conj())
    c = c.real if np.abs(c.real).max() >= np.abs(c.imag).max() else c.imag
    c = c / np.linalg.norm(c)
    flat = c.reshape(-1)
    if flat[np.flatnonzero(np.abs(flat) > 1e-6)[0]] < 0:
        c = -c
    return c * math.sqrt(2 * l3 + 1)


@functools.lru_cache(maxsize=None)
def basis(nu: int, big_l: int) -> np.ndarray:
    """U^{nu,L} [16]*nu + [2L + 1, n], float64."""
    trees = []
    ls = range(LMAX + 1)
    if nu == 1:
        t = np.zeros((DIM, 2 * big_l + 1))
        t[block(big_l)] = np.eye(2 * big_l + 1)
        trees.append(t)
    elif nu == 2:
        for l1, l2 in itertools.product(ls, ls):
            if (l1 + l2 + big_l) % 2 == 0 and abs(l1 - l2) <= big_l <= l1 + l2:
                t = np.zeros((DIM, DIM, 2 * big_l + 1))
                t[block(l1), block(l2)] = clebsch_gordan(l1, l2, big_l)
                trees.append(t)
    else:
        for l1, l2, l3 in itertools.product(ls, ls, ls):
            if (l1 + l2 + l3 + big_l) % 2:
                continue
            for l12 in range(abs(l1 - l2), l1 + l2 + 1):
                if abs(l12 - l3) <= big_l <= l12 + l3:
                    t = np.zeros((DIM,) * 3 + (2 * big_l + 1,))
                    t[block(l1), block(l2), block(l3)] = np.einsum(
                        'abk,kcm->abcm', clebsch_gordan(l1, l2, l12),
                        clebsch_gordan(l12, l3, big_l))
                    trees.append(t)
    out = []
    perms = list(itertools.permutations(range(nu)))
    for t in trees:
        v = (sum(np.transpose(t, p + (nu,)) for p in perms)
             / len(perms)).reshape(-1)
        for _ in range(2):
            for b in out:
                v = v - (b @ v) * b
        if np.linalg.norm(v) >= 1e-9:
            out.append(v / np.linalg.norm(v))
    u = np.stack(out, -1).reshape((DIM,) * nu + (2 * big_l + 1, len(out)))
    if u.shape[-1] != mace_params.BASIS_SIZES[nu, big_l]:
        raise AssertionError(f'U^{nu},{big_l} has {u.shape[-1]} elements')
    return u


def silu_norm() -> float:
    x, w = np.polynomial.hermite_e.hermegauss(200)
    second = np.sum(w * (x / (1.0 + np.exp(-x))) ** 2) / math.sqrt(2 * math.pi)
    return float(1.0 / math.sqrt(second))


# ---- Work.

def mace_work(counts: dict) -> dict:
    """Work classes of one force evaluation (``work.py``'s classes), as
    FP32 operations (an FMA two; TF32 is off), per directed pair inside rc
    and per atom:

    * the radial MLPs R -> 64 -> 64 -> 64 -> P_t F, forward and the
      input-side backward, every layer;
    * the messages, per pair and path (l1, l2, l3): forward X = R h_j
      (F (2l1 + 1)) and its product with Y_l2 (2 F (2l1 + 1)(2l2 + 1));
      backward the Y and X cotangents (4 F (2l1 + 1)(2l2 + 1)), R's (2 F
      (2l1 + 1)) and the mirrored h cotangent (F (2l3 + 1) (2 (2l1 + 1)
      + 1));
    * the symmetric contraction, per atom and channel, nested as mace
      nests it, forward and backward alike: 2 M (16^3 + 16^2 + 16), M the
      layer's output components (4, then 1);
    * the per-atom linears (skip, up, mid, the product's), forward and
      input gradient, and the readouts;

    special-function operations per pair: the 8 sines and the length's
    sqrt forward, the 8 cosines backward, and the SiLU's exponential of
    every hidden unit of the radial MLPs, forward and backward. Bytes:
    positions, species and parameters read once, forces and the energy
    written once."""
    pairs, n = counts['mace_pairs'], counts['atoms']
    f, r, e = counts['channels'], counts['radial'], counts['species']
    hidden = counts['radial_mlp']
    fp32 = sfu = 0
    params = e * f + f + f * counts['readout_hidden'] * 2
    for l_in, l_out in counts['layers']:
        ps = mace_params.paths(l_in)
        widths = (r, *hidden, len(ps) * f)
        macs = sum(a * b for a, b in zip(widths, widths[1:]))
        fp32 += pairs * 2 * 2 * macs
        sfu += pairs * 2 * sum(hidden)
        for l1, l2, l3 in ps:
            a, b, c = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
            fwd = f * a + 2 * f * a * b
            bwd = 4 * f * a * b + 2 * f * a + f * c * (2 * a + 1)
            fp32 += pairs * (fwd + bwd)
        m = sum(2 * big_l + 1 for big_l in l_out)
        fp32 += n * f * 2 * 2 * m * (DIM ** 3 + DIM ** 2 + DIM)
        # skip, up and the product's linear on each component, and mid.
        c_in = sum(2 * l + 1 for l in l_in)
        lin = f * f * (1 + c_in + m) + sum(
            sum(p[2] == l for p in ps) * f * f * (2 * l + 1) for l in range(4))
        fp32 += n * 2 * 2 * lin
        params += (e * f * f + len(l_in) * f * f + macs
                   + len(ps) * f * f + len(l_out) * f * f
                   + e * f * sum(mace_params.BASIS_SIZES[nu, big_l]
                                 for nu in (1, 2, 3) for big_l in l_out))
    fp32 += n * 2 * 2 * (f * counts['readout_hidden'] + f)
    sfu += pairs * (2 * r + 1)
    return {'fp32': fp32, 'sfu': sfu,
            'bytes': 4 * params + n * (12 + 4 + 12) + 4}


class Reference:
    """MACE on one box: ``energy_forces_and_ani(positions)``."""

    def __init__(self, cfg: dict, setup):
        self.cfg = cfg
        self.device = dev = setup.device
        self.params = mace_params.make(cfg, setup.weights, dev)
        self.rc = float(cfg['cutoff'])
        self.p = int(cfg['cutoff_p'])
        self.f = int(cfg['channels'])
        self.radial = int(cfg['radial'])
        self.num_species = len(cfg['elements'])
        self.avg = float(cfg['avg_num_neighbors'])
        self.act = silu_norm()
        self.species = torch.as_tensor(
            species_index(setup.atomic_numbers, cfg['elements']), device=dev)
        self.groups = [(s, torch.nonzero(self.species == s)[:, 0])
                       for s in sorted(set(self.species.tolist()))]
        self.lengths = box_lengths(setup.box)
        self.pair_list = PairList(self.lengths, self.rc)
        self.layers = [mace_params.layer_irreps(cfg, t)
                       for t in range(int(cfg['interactions']))]
        self.cg = {p: torch.as_tensor(clebsch_gordan(*p), dtype=torch.float32,
                                      device=dev)
                   for l_in, _ in self.layers for p in mace_params.paths(l_in)}
        self.u = {(nu, big_l): torch.as_tensor(basis(nu, big_l),
                                               dtype=torch.float32, device=dev)
                  for _, l_out in self.layers for big_l in l_out
                  for nu in (1, 2, 3)}

    def _silu(self, x):
        return self.act * torch.nn.functional.silu(x)

    def _messages(self, pos, h_up, radial, i, j, r0, rows, l_in, control):
        """The messages of rows r0 .. r0 + rows from their pairs (i, j),
        one [rows, F, 2l3 + 1] a path."""
        rnd = ((lambda t: _Round.apply(t, torch.bfloat16)) if control
               else (lambda t: t))
        f = self.f
        d = minimum_image(pos[j] - pos[i], self.lengths)
        r = torch.sqrt(torch.sum(d * d, -1))
        y = harmonics(d / r[:, None])
        x = r / self.rc
        fcut = (1 - 0.5 * (self.p + 1) * (self.p + 2) * x ** self.p
                + self.p * (self.p + 2) * x ** (self.p + 1)
                - 0.5 * self.p * (self.p + 1) * x ** (self.p + 2))
        n = torch.arange(1, self.radial + 1, dtype=r.dtype, device=r.device)
        emb = (math.sqrt(2 / self.rc) * torch.sin(r[:, None] * n * math.pi
                                                  / self.rc)
               / r[:, None] * fcut[:, None])
        for k, w in enumerate(radial):
            emb = rnd(emb) @ rnd(w / math.sqrt(w.shape[0]))
            if k < len(radial) - 1:
                emb = self._silu(emb)
        ps = mace_params.paths(l_in)
        weights = emb.view(-1, len(ps), f)
        hj = h_up[j]
        out = []
        for q, (l1, l2, l3) in enumerate(ps):
            # sum_m2 C Y first: [pairs, 2l1 + 1, 2l3 + 1] a pair.
            cy = torch.einsum('pb,abc->pac', y[:, block(l2)],
                              self.cg[l1, l2, l3])
            xa = weights[:, q, :, None] * hj[:, :, block(l1)]
            msg = sum(xa[:, :, a, None] * cy[:, None, a, :]
                      for a in range(2 * l1 + 1))
            out.append(torch.zeros(rows, f, 2 * l3 + 1, dtype=msg.dtype,
                                   device=msg.device).index_add(0, i - r0,
                                                                msg))
        return tuple(out)

    def _contract(self, a, weights, l_out):
        """B [N, F, M] of A [N, F, 16], species group by group, atom block
        by atom block, channels first: T_nu = U^nu W_nu[z] contracted with
        A one slot at a time, first slot first, under autograd."""
        n, f = a.shape[0], a.shape[1]
        m = sum(2 * big_l + 1 for big_l in l_out)
        out = torch.zeros(n, f, m, dtype=a.dtype, device=a.device)
        for s, idx in self.groups:
            t = [torch.cat([torch.einsum('...Me,ec->c...M',
                                         self.u[nu, big_l], w[nu - 1][s])
                            for big_l, w in zip(l_out, weights)], -1)
                 for nu in (1, 2, 3)]

            def group_block(x, t1, t2, t3):
                x = x.transpose(0, 1)                          # [F, n, 16]
                k = x.shape[1]
                xs = x.reshape(f * k, 1, DIM)
                o = torch.bmm(x, t3.reshape(f, DIM, -1)).view(
                    f, k, DIM, DIM * m) + t2.reshape(f, 1, DIM, DIM * m)
                o = torch.bmm(xs, o.view(f * k, DIM, DIM * m)).view(
                    f, k, DIM, m) + t1[:, None]
                return torch.bmm(xs, o.view(f * k, DIM, m)).view(
                    f, k, m).transpose(0, 1)

            parts = [checkpoint(group_block, a[idx[b:b + ATOM_BLOCK]], *t,
                                use_reentrant=False)
                     for b in range(0, idx.numel(), ATOM_BLOCK)]
            out = out.index_copy(0, idx, torch.cat(parts))
        return out

    def energy_forces_and_ani(self, positions: Tensor, control=False):
        """(energy [] float64, forces [N, 3] float32, None) at
        ``positions``; ``control``: the radial MLPs' and the up linears'
        operands in bfloat16."""
        n, f = positions.shape[0], self.f
        i, j, _ = self.pair_list(positions.detach())
        starts = torch.searchsorted(
            i, torch.arange(0, n + ROW_BLOCK, ROW_BLOCK,
                            device=i.device).clamp_(max=n)).tolist()
        rnd = ((lambda t: _Round.apply(t, torch.bfloat16)) if control
               else (lambda t: t))
        p = self.params
        pos = positions.detach().float().requires_grad_(True)
        with no_tf32(), torch.enable_grad():
            h = (p.embedding[self.species]
                 / math.sqrt(self.num_species))[:, :, None]
            scalars = []
            for layer, (l_in, l_out) in zip(p.layers, self.layers):
                sc = torch.einsum('nf,nfg->ng', h[:, :, 0],
                                  layer.skip[self.species]) / math.sqrt(
                                      f * self.num_species)
                h_up = torch.cat([
                    torch.einsum('nfm,fg->ngm', rnd(h[..., block(l)]),
                                 rnd(w)) / math.sqrt(f)
                    for l, w in zip(l_in, layer.up)], -1)
                parts = [
                    checkpoint(self._messages, pos, h_up, layer.radial,
                               i[a:b], j[a:b], r0, min(n, r0 + ROW_BLOCK) - r0,
                               l_in, bool(control), use_reentrant=False)
                    for r0, a, b in zip(range(0, n, ROW_BLOCK), starts,
                                        starts[1:])]
                ps = mace_params.paths(l_in)
                msgs = [torch.cat([part[q] for part in parts])
                        for q in range(len(ps))]
                a_parts = []
                for l3, w in enumerate(layer.mid):
                    m3 = torch.cat([msgs[q] for q, pth in enumerate(ps)
                                    if pth[2] == l3], 1)
                    a_parts.append(torch.einsum('nfm,fg->ngm', m3, w)
                                   / math.sqrt(w.shape[0]))
                a_feat = torch.cat(a_parts, -1) / self.avg
                b = self._contract(a_feat, layer.weights, l_out)
                hs, col = [], 0
                for big_l, w in zip(l_out, layer.linear):
                    hs.append(torch.einsum('nfm,fg->ngm',
                                           b[..., col:col + 2 * big_l + 1], w)
                              / math.sqrt(f))
                    col += 2 * big_l + 1
                hs[0] = hs[0] + sc[..., None]
                h = torch.cat(hs, -1)
                scalars.append(h[:, :, 0])
            e_atoms = sum(s @ p.readout1 for s in scalars[:-1]) / math.sqrt(f)
            e_atoms = e_atoms + (self._silu(scalars[-1] @ p.readout2_w1
                                            + p.readout2_b1)
                                 @ p.readout2_w2 + p.readout2_b2)[:, 0]
            energy = torch.sum(e_atoms.double())
            (grad,) = torch.autograd.grad(energy, pos)
        return energy.detach(), -grad.detach(), None

    # ---- Work.

    @torch.no_grad()
    def work_counts(self, positions: Tensor) -> dict:
        """The interactions a force evaluation needs at ``positions``: the
        directed pairs inside rc and the atoms, with the shapes they are
        counted at."""
        i, _, _ = pairs_within(positions, self.lengths, self.rc)
        return {'mace_pairs': int(i.numel()),
                'atoms': int(positions.shape[0]),
                'channels': self.f, 'radial': self.radial,
                'radial_mlp': list(self.cfg['radial_mlp']),
                'readout_hidden': int(self.cfg['readout_hidden']),
                'species': self.num_species,
                'layers': [[list(a), list(b)] for a, b in self.layers]}

    def work(self, cfg: dict, counts: dict) -> dict:
        """The essential work of one force evaluation (``work.py``'s
        classes)."""
        return mace_work(counts)


def make(cfg: dict, setup) -> Reference:
    return Reference(cfg, setup)
