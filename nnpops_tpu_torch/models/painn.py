"""PaiNN, the polarizable atom interaction neural network (Schütt, Unke and
Gastegger, "Equivariant message passing for the prediction of tensorial
properties and molecular spectra", ICML 2021; SchNetPack's
``schnetpack.representation.PaiNN``), as an MD potential on the cell
list's path.

Every atom carries a scalar state s [F] and a vector state v [3, F]; with
r_ij = R_j - R_i under the minimum image, d = |r_ij|, u = r_ij / d and the
cosine cutoff fc, from s = embedding[species], v = 0, each block is

* message (``ops.painn.painn_message``):
  phi(s) = W2 SiLU(W1 s + b1) + b2 (F -> F -> 3F);
  W_ij = (rbf(d) Wf + bf) fc(d), rbf_n = sin(n pi d / rc) / d (R -> 3F);
  x = phi(s_j) * W_ij = (x_s, x_vv, x_vs);
  s_i += sum_j x_s,  v_i += sum_j (v_j * x_vv + u_ij (x) x_vs);
* update: (Uv, Vv) = v [U V] over each component (F -> 2F, no bias);
  a = A2 SiLU(A1 [s, sqrt(sum_c (Vv)^2 + 1e-8)] + c1) + c2 (2F -> F -> 3F)
  = (a_vv, a_sv, a_ss);  v += a_vv * Uv;  s += a_sv * sum_c Uv . Vv + a_ss;

and the energy is E = sum_i R2 SiLU(R1 s_i + r1) + r2 (F -> F/2 -> 1).

Departures from SchNetPack:

* the embedding is indexed by the order of the model's ``elements``, not
  by atomic number;
* one filter network per block, (R -> 3F) each: SchNetPack's one dense
  layer R -> 3F x blocks, split by block, is the same map;
* the splits follow the equations above: SchNetPack orders the message's
  (x_s, x_vs, x_vv), the update's (a_ss, a_vv, a_sv) and its (Vv, Uv);
  with random weights that is a permutation of their columns;
* the readout has no standardisation (mean and scale) and no atom
  reference energies.

The MD path (``from_atomic_numbers``, then ``create_cell_list``, ``select``,
``energy_and_forces_from_selection``, ``overflow_counts``,
``capacities``: the entry points ``md.integrators.run_md_sticky_counts``
drives) takes the deltas payload of the mirrored selection
(``CellList.payload_deltas_from_selection``), whose position adjoint, like
the message's, is scatter-free. Parameters are NamedTuples in the ``[in,
out]`` layout (``x @ w``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import PaiNNConfig
from ..neighbors.cell_list import CellList, SlotSelection, lane_geometry
from ..ops.batched_nn import resolve_device
from ..ops.painn import painn_message
from ..utils.profiling import span
from .md_path import CellListPath, species_of, with_forces
from .schnet import DenseParams

Tensor = torch.Tensor

NORM_EPS = 1e-8     # under the update's vector norm (SchNetPack's epsilon)
BIAS_SCALE = 0.1    # the standard deviation of ``init``'s biases


class MessageParams(NamedTuple):
    phi1: DenseParams      # F -> F, SiLU
    phi2: DenseParams      # F -> 3F
    filter: DenseParams    # R -> 3F


class UpdateParams(NamedTuple):
    uv: Tensor             # [F, 2F] (U | V), no bias
    a1: DenseParams        # 2F -> F, SiLU
    a2: DenseParams        # F -> 3F


class PaiNNBlock(NamedTuple):
    message: MessageParams
    update: UpdateParams


class PaiNNParams(NamedTuple):
    embedding: Tensor                 # [num_species, F]
    blocks: Tuple[PaiNNBlock, ...]
    readout1: DenseParams             # F -> F/2, SiLU
    readout2: DenseParams             # F/2 -> 1


def _dense(p: DenseParams, x: Tensor) -> Tensor:
    return x @ p.w + p.b


def _silu(x: Tensor) -> Tensor:
    return torch.nn.functional.silu(x)


def update(p: UpdateParams, s: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """The update block on s [N, F] and v [N, 3, F]."""
    f = s.shape[1]
    uv, vv = (v @ p.uv).split(f, -1)
    norm = torch.sqrt(torch.sum(vv * vv, 1) + NORM_EPS)
    a_vv, a_sv, a_ss = _dense(p.a2, _silu(_dense(
        p.a1, torch.cat([s, norm], -1)))).split(f, -1)
    return (s + a_sv * torch.sum(uv * vv, 1) + a_ss,
            v + a_vv[:, None, :] * uv)


@dataclasses.dataclass(frozen=True)
class PaiNNModel(CellListPath):
    """PaiNN potential of one system (``from_atomic_numbers``): embedding,
    ``num_interactions`` message and update blocks, atomwise readout."""
    config: PaiNNConfig
    num_species: int
    num_interactions: int = 3
    species: Tuple[int, ...] = ()

    @classmethod
    def from_atomic_numbers(cls, atomic_numbers, config: PaiNNConfig,
                            elements, num_interactions: int = 3
                            ) -> 'PaiNNModel':
        """The model of one system: species ``elements.index(z)`` for each
        atomic number."""
        species, num_species = species_of(atomic_numbers, elements)
        return cls(config, num_species, num_interactions, species)

    def init(self, generator: torch.Generator, device=None) -> PaiNNParams:
        """Random parameters drawn with ``generator`` on ``device`` (the
        card unless the caller says otherwise): a unit-normal embedding,
        dense weights Glorot uniform as SchNetPack's ``Dense`` draws them
        (the filter layers at the fan-out of SchNetPack's one filter layer,
        3F x blocks), biases normal times ``BIAS_SCALE`` (not SchNetPack's
        zeros, so that a bias wired wrongly shows)."""
        dev = resolve_device(device)

        def draw(fn, *shape):
            return fn(*shape, generator=generator,
                      device=generator.device).to(dev)

        def glorot(n_in, n_out, fan_out=None):
            bound = np.sqrt(6.0 / (n_in + (fan_out or n_out)))
            return (2.0 * draw(torch.rand, n_in, n_out) - 1.0) * bound

        def dense(n_in, n_out, fan_out=None):
            return DenseParams(glorot(n_in, n_out, fan_out),
                               BIAS_SCALE * draw(torch.randn, n_out))

        f, r, b = (self.config.width, self.config.num_radial,
                   self.num_interactions)
        embedding = draw(torch.randn, self.num_species, f)
        blocks = tuple(PaiNNBlock(
            MessageParams(dense(f, f), dense(f, 3 * f),
                          dense(r, 3 * f, 3 * f * b)),
            UpdateParams(glorot(f, 2 * f), dense(2 * f, f), dense(f, 3 * f)))
            for _ in range(b))
        return PaiNNParams(embedding, blocks, dense(f, f // 2),
                           dense(f // 2, 1))

    def energy_and_forces_from_selection(self, params: PaiNNParams,
                                         positions: Tensor, box: Tensor,
                                         cell_list: CellList,
                                         sel: SlotSelection
                                         ) -> Tuple[Tensor, Tensor]:
        """Energy and forces = -dE/dpositions against a frozen selection:
        the scatter-free deltas payload and its lane geometry, the blocks
        (the message's adjoint hand-written, lanes past the cutoff masked
        there), the readout."""
        n, f = len(self.species), self.config.width

        def energy(pos):
            with span('force.distances'):
                deltas, idx, mask = cell_list.payload_deltas_from_selection(
                    pos, box, sel)
                d, u = lane_geometry(deltas, mask)
            s = params.embedding.index_select(0, self._species_on(pos.device))
            v = s.new_zeros(n, 3, f)
            for block in params.blocks:
                m = block.message
                with span('force.message'):
                    phi = _dense(m.phi2, _silu(_dense(m.phi1, s)))
                    ms, mv = painn_message(phi, v, d, u, idx, mask, m.filter.w,
                                           m.filter.b, self.config)
                    s, v = s + ms, v + mv
                with span('force.update'):
                    s, v = update(block.update, s, v)
            with span('force.readout'):
                h = _silu(_dense(params.readout1, s))
                return torch.sum(_dense(params.readout2, h)[:, 0])
        return with_forces(energy, positions)
