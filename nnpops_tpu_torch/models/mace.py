"""MACE (Batatia, Kovacs, Simm, Ortner and Csanyi, "MACE: Higher Order
Equivariant Message Passing Neural Networks for Fast and Accurate Force
Fields", NeurIPS 2022, arXiv:2206.07697; ACEsuit/mace ``MACE`` and
``ScaleShiftMACE`` in ``mace/modules/models.py``, ``blocks.py``,
``symmetric_contraction.py``), by default at MACE-OFF23 medium's widths,
as an MD potential on the cell list's path.

Notation: r_ij = R_j - R_i under the minimum image, d = |r_ij|, r^ =
r_ij / d, e_i atom i's one-hot over the configuration's E elements, F =
``channels``; irreps have natural parity (0e, 1o, 2e, 3o), and a node
feature h [F, sum (2l + 1)] holds the components of l = 0, 1, .. in
order (``ops.so3.block``).

Edges (``force.distances``):

* Y(r^): the real harmonics l = 0 .. 3, component-normalised (sum_m
  Y_lm^2 = 2l + 1), 16 values (``ops.so3.spherical_harmonics``);
* e_n(d) = sqrt(2 / rc) sin(n pi d / rc) / d * f(d / rc), n = 1 .. R
  (mace's ``BesselBasis`` times its ``PolynomialCutoff``), f(x) = 1 - (p +
  1)(p + 2)/2 x^p + p(p + 2) x^(p+1) - p(p + 1)/2 x^(p+2) below rc (1 -
  21 x^5 + 35 x^6 - 15 x^7 at p = 5) and 0 beyond: exactly zero on padded
  and skin lanes;
* R^(t)(d) = MLP(R -> 64 -> 64 -> 64 -> P_t F), e3nn's
  ``FullyConnectedNet``: no biases, each layer x W / sqrt(fan-in), SiLU
  rescaled to a unit second moment (x 1.679, ``ops.mace.SILU_NORM``)
  between layers.

Layers t = 1, 2, from h^(0) = e_i W_emb / sqrt(E) (128x0e), each mace's
``RealAgnosticResidualInteractionBlock`` and
``EquivariantProductBasisBlock``:

* skip: sc_i = h_i,0e W_sc[z_i] / sqrt(F E) (e3nn's
  ``FullyConnectedTensorProduct`` of h with the one-hot: only 0e (x) 0e
  -> 0e reaches the layer's outputs, so sc is a scalar in both layers);
* up: h~_l = h_l W_up,l / sqrt(F) for each l of h;
* message (``ops.mace.mace_message``): for each path p = (l1, l2 -> l3) of
  ``ops.mace.message_paths`` (4 in layer 1, 10 in layer 2),
  m_i^p[k, m3] = sum_{j : d < rc} R_p,k(d) sum_{m1 m2}
  C^{l1 l2 l3}_{m1 m2 m3} h~_j[k, l1 m1] Y_l2 m2(r^_ij), C the real 3j
  times sqrt(2 l3 + 1) (``ops.so3.clebsch_gordan``: e3nn's component
  normalisation of a path with external weights);
* A_i,l3 = sum_{p -> l3} m_i^p W_mid,p / sqrt(P_l3 F) / avg_num_neighbors
  ([N, F, 16]);
* product (``ops.mace.symmetric_contraction``): B_i[k, LM] = sum_{nu=1..3}
  sum_eta W_nu,L[z_i, eta, k] sum U^{nu,L}_eta[m1 .. m_nu, M] prod_xi
  A_i[k, m_xi], L in {0e, 1o} in layer 1 and {0e} in layer 2;
* h^(t)_L = B_L W_L / sqrt(F), plus sc on 0e;
* readouts: E_i^(1) = h^(1)_i,0e w / sqrt(F) (mace's
  ``LinearReadoutBlock``); E_i^(2) = SiLU_n(h^(2)_i,0e W1 + b1) W2 + b2,
  F -> 16 -> 1 (``NonLinearReadoutBlock``), with W1, W2 already fan-in
  scaled (the benchmark harness's one network is this readout).

E = sum_i (E_i^(1) + E_i^(2)); the scale is 1, the shift 0 and every E0 0.

Coefficients: C and U (``ops.so3``) float64, built once and cached.

Departures from mace:

* U^{nu,L} is an orthonormal basis of the same space as mace's
  ``U_matrix_real`` (coupling trees, symmetrised, Gram-Schmidt in the
  order ``ops.so3`` states), so with random weights the two differ by an
  orthogonal change of W_nu,L's basis;
* the real harmonics carry no Condon-Shortley phase and order m = -l .. l
  with l = 1 as (y, z, x) (e3nn's (x, y, z)), and the 3j symbols' signs
  follow ``ops.so3``: with random weights a fixed orthogonal change of
  the irreps' bases;
* SILU_NORM is exact (quadrature), not e3nn's sampled estimate;
* the embedding and every species-indexed weight follow the order of the
  model's ``elements``, not the atomic number;
* the weights are random (``init``), not trained.

The MD path (``from_atomic_numbers``, then ``create_cell_list``,
``select``, ``energy_and_forces_from_selection``, ``overflow_counts``,
``capacities``) takes the deltas payload of the mirrored selection, whose
position adjoint, like the message's and the contraction's, is
scatter-free, cut to the selection's largest neighbor count rounded up
to 8 (``lanes``: the valid lanes of a row come first, so no pair inside
the cutoff is cut; 80 of K 128 on the 26k water frame). Parameters are NamedTuples of raw weights in the ``[in,
out]`` layout; the constants above are applied in the forward.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import MACEConfig
from ..neighbors.cell_list import CellList, SlotSelection, lane_geometry
from ..ops import so3
from ..ops.batched_nn import resolve_device
from ..ops.mace import (message_paths, mace_message, silu_n,
                        symmetric_contraction)
from ..utils.profiling import span
from .md_path import CellListPath, species_of, with_forces
from .schnet import DenseParams

Tensor = torch.Tensor


class InteractionParams(NamedTuple):
    skip: Tensor                  # [E, F, F]
    up: Tuple[Tensor, ...]        # per l of the input: [F, F]
    radial: Tuple[Tensor, ...]    # [R, 64], [64, 64], [64, 64], [64, P F]
    mid: Tuple[Tensor, ...]       # per l3: [P_l3 F, F]


class ProductParams(NamedTuple):
    weights: Tuple[Tuple[Tensor, ...], ...]   # per output L, per nu: [E, n, F]
    linear: Tuple[Tensor, ...]                # per output L: [F, F]


class MACELayer(NamedTuple):
    interaction: InteractionParams
    product: ProductParams


class MACEParams(NamedTuple):
    embedding: Tensor                 # [E, F]
    layers: Tuple[MACELayer, ...]
    readout1: Tensor                  # [F]: each non-last layer's 0e -> 1
    readout2: Tuple[DenseParams, DenseParams]   # F -> 16 -> 1, pre-scaled


def radial_basis(d: Tensor, live: Tensor, config: MACEConfig) -> Tensor:
    """e [N, K, R] of the lanes' lengths ``d``: the Bessel basis times the
    polynomial cutoff, exactly zero where not ``live``."""
    rc, p = float(config.cutoff), config.cutoff_p
    ds = torch.where(live, d, rc)
    x = ds / rc
    xp = x ** p
    fcut = (1.0 - 0.5 * (p + 1) * (p + 2) * xp + p * (p + 2) * xp * x
            - 0.5 * p * (p + 1) * xp * x * x)
    n = torch.arange(1, config.num_radial + 1, dtype=d.dtype, device=d.device)
    e = (math.sqrt(2.0 / rc) * torch.sin(ds[..., None] * (n * math.pi / rc))
         / ds[..., None] * fcut[..., None])
    return torch.where(live[..., None], e, 0.0)


def _linear(h: Tensor, w: Tensor) -> Tensor:
    """[N, F_in, m] -> [N, F_out, m]: e3nn's ``Linear`` of one irrep."""
    return torch.einsum('nfm,fg->ngm', h, w) * (1.0 / math.sqrt(w.shape[0]))


@dataclasses.dataclass(frozen=True)
class MACEModel(CellListPath):
    """MACE potential of one system (``from_atomic_numbers``): embedding,
    ``num_interactions`` interaction and product layers, a readout after
    each."""
    config: MACEConfig
    num_species: int
    num_interactions: int = 2
    species: Tuple[int, ...] = ()

    @classmethod
    def from_atomic_numbers(cls, atomic_numbers, config: MACEConfig,
                            elements, num_interactions: int = 2
                            ) -> 'MACEModel':
        """The model of one system: species ``elements.index(z)`` for each
        atomic number."""
        species, num_species = species_of(atomic_numbers, elements)
        return cls(config, num_species, num_interactions, species)

    # ---- Layout.

    def inputs_l(self, t: int) -> Tuple[int, ...]:
        """The l of layer ``t``'s input node features."""
        return (0,) if t == 0 else tuple(range(self.config.hidden_l + 1))

    def outputs_l(self, t: int) -> Tuple[int, ...]:
        """The l of layer ``t``'s output node features (0e in the last)."""
        return ((0,) if t == self.num_interactions - 1
                else tuple(range(self.config.hidden_l + 1)))

    def paths(self, t: int):
        """Layer ``t``'s message paths (``ops.mace.message_paths``)."""
        return message_paths(self.inputs_l(t))

    @functools.cached_property
    def _groups_on(self) -> dict:
        return {}

    @functools.cached_property
    def _lanes_of(self) -> dict:
        return {}

    def lanes(self, sel: SlotSelection, capacity: int) -> int:
        """The lanes the force calls of a selection take: its largest
        neighbor count (the valid lanes of a row come first), rounded up
        to 8, at most ``capacity``; read from the card once a selection."""
        seen = self._lanes_of.get('mask')
        if seen is not sel.mask:
            k = -(-int(sel.max_neighbors) // 8) * 8
            self._lanes_of.update(mask=sel.mask, k=max(8, min(capacity, k)))
        return self._lanes_of['k']

    def _groups(self, device) -> Tuple[tuple, Tensor, tuple]:
        """(species, its atoms) of each species present, the inverse of
        their concatenation, and each present species' 0/1 mask [N], on
        ``device``; uploaded once."""
        device = torch.device(device)
        if device not in self._groups_on:
            z = np.asarray(self.species, np.int64)
            present = sorted(set(self.species))
            order = np.concatenate([np.flatnonzero(z == s) for s in present])
            inverse = np.empty_like(order)
            inverse[order] = np.arange(len(order))
            self._groups_on[device] = (
                tuple((s, torch.as_tensor(np.flatnonzero(z == s),
                                          device=device)) for s in present),
                torch.as_tensor(inverse, device=device),
                tuple((s, torch.as_tensor(z == s, device=device))
                      for s in present))
        return self._groups_on[device]

    def init(self, generator: torch.Generator, device=None) -> MACEParams:
        """Random parameters drawn with ``generator`` on ``device`` (the
        card unless the caller says otherwise): every weight unit normal
        (e3nn's), W_nu,L normal / n (mace's), the last readout's layers
        normal / sqrt(fan-in) with biases normal x 0.1."""
        dev = resolve_device(device)
        c = self.config
        f, e = c.channels, self.num_species

        def normal(*shape):
            return torch.randn(*shape, generator=generator,
                               device=generator.device).to(dev)

        layers = []
        for t in range(self.num_interactions):
            paths = self.paths(t)
            widths = (c.num_radial, *c.radial_mlp, len(paths) * f)
            by_l3 = [sum(p.l3 == l for p in paths) for l in range(so3.LMAX + 1)]
            interaction = InteractionParams(
                normal(e, f, f), tuple(normal(f, f) for _ in self.inputs_l(t)),
                tuple(normal(a, b) for a, b in zip(widths, widths[1:])),
                tuple(normal(n * f, f) for n in by_l3))
            weights = []
            for big_l in self.outputs_l(t):
                counts = [so3.symmetric_basis(nu, big_l).shape[-1]
                          for nu in range(1, c.correlation + 1)]
                weights.append(tuple(normal(e, n, f) / n for n in counts))
            product = ProductParams(tuple(weights), tuple(
                normal(f, f) for _ in self.outputs_l(t)))
            layers.append(MACELayer(interaction, product))
        h = c.readout_hidden
        readout2 = (DenseParams(normal(f, h) / math.sqrt(f), 0.1 * normal(h)),
                    DenseParams(normal(h, 1) / math.sqrt(h), 0.1 * normal(1)))
        return MACEParams(normal(e, f), tuple(layers), normal(f), readout2)

    # ---- The force call.

    def _interaction(self, t: int, p: InteractionParams, h: Tensor,
                     y: Tensor, e: Tensor, idx: Tensor) -> Tuple[Tensor,
                                                                 Tensor]:
        """(A [N, F, 16], sc [N, F]) of layer ``t``."""
        f = self.config.channels
        _, _, masks = self._groups(h.device)
        h0 = h[:, :, 0]
        sc = sum(mask[:, None] * (h0 @ p.skip[s]) for s, mask in masks)
        sc = sc * (1.0 / math.sqrt(f * self.num_species))
        h_up = torch.cat([_linear(h[..., so3.block(l)], w)
                          for l, w in zip(self.inputs_l(t), p.up)], -1)
        scale = [1.0 / math.sqrt(w.shape[0]) for w in p.radial]
        weights = [w * s for w, s in zip(p.radial, scale)]
        ms = mace_message(h_up, y, e, idx, weights, self.paths(t))
        a = [_linear(m.flatten(1, 2), w) for m, w in zip(ms, p.mid)]
        return torch.cat(a, -1) * (1.0 / self.config.avg_num_neighbors), sc

    def _product(self, t: int, p: ProductParams, a: Tensor,
                 sc: Tensor) -> Tensor:
        groups, inverse, _ = self._groups(a.device)
        outputs = self.outputs_l(t)
        b = symmetric_contraction(a, outputs, p.weights, groups, inverse)
        hs, col = [], 0
        for big_l, w in zip(outputs, p.linear):
            hs.append(_linear(b[..., col:col + 2 * big_l + 1], w))
            col += 2 * big_l + 1
        hs[0] = hs[0] + sc[..., None]
        return torch.cat(hs, -1)

    def energy_and_forces_from_selection(self, params: MACEParams,
                                         positions: Tensor, box: Tensor,
                                         cell_list: CellList,
                                         sel: SlotSelection
                                         ) -> Tuple[Tensor, Tensor]:
        """Energy and forces = -dE/dpositions against a frozen selection:
        the scatter-free deltas payload, its lane geometry, harmonics and
        radial basis; the layers (the message's and the contraction's
        adjoints hand-written); the readouts."""
        c = self.config
        f = c.channels

        def energy(pos):
            with span('force.distances'):
                deltas, idx, mask = cell_list.payload_deltas_from_selection(
                    pos, box, sel)
                k = self.lanes(sel, cell_list.capacity)
                deltas, idx, mask = deltas[:, :k], idx[:, :k], mask[:, :k]
                d, u = lane_geometry(deltas, mask)
                live = mask & (d < c.cutoff)
                y = so3.spherical_harmonics(u)
                e = radial_basis(d, live, c)
            species = self._species_on(pos.device)
            h = (params.embedding.index_select(0, species)
                 * (1.0 / math.sqrt(self.num_species)))[:, :, None]
            scalars = []
            for t, layer in enumerate(params.layers):
                with span('force.interaction'):
                    a, sc = self._interaction(t, layer.interaction, h, y, e,
                                              idx)
                with span('force.product'):
                    h = self._product(t, layer.product, a, sc)
                scalars.append(h[:, :, 0])
            with span('force.readout'):
                total = sum(torch.sum(s @ params.readout1)
                            for s in scalars[:-1]) * (1.0 / math.sqrt(f))
                w1, w2 = params.readout2
                e2 = silu_n(scalars[-1] @ w1.w + w1.b) @ w2.w + w2.b
                return total + torch.sum(e2)
        return with_forces(energy, positions)
