"""A SchNet model family on the CFConv op (port of
``nnpops_tpu.models.schnet``).

* :class:`CFConvStack`: the reference benchmark workload, one neighbor
  build shared by L convolutions (BenchmarkCudaCFConv.cu:105-111), over
  the half pair list (``__call__``), a cell-list payload
  (``apply_payload``) or the (distances, indices, mask) triple of
  ``CellList.payload_distances_from_selection`` (``apply_distances``, the
  production path at large N).
* :class:`SchNetModel`: a SchNet potential, species embedding ->
  interaction blocks (atomwise dense, CFConv, atomwise dense + residual)
  -> per-atom readout -> summed energy, forces by autograd; over the O(N^2)
  pair list (``energy``, ``energy_and_forces``) or, built with
  ``from_atomic_numbers``, on the MD path of the cell list (``select``,
  ``energy_and_forces_from_selection``, ``overflow_counts``: the entry
  points of ``ANIModel`` that ``md.integrators.run_md_sticky_counts``
  drives).

Parameters are plain NamedTuples of tensors in the JAX ``[in, out]``
layout (``params.schnet_params_from_jax`` carries JAX weights across).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import CFConvConfig
from ..neighbors.cell_list import CellList, SlotSelection
from ..neighbors.pairs import MaskedPairs
from ..ops.batched_nn import resolve_device
from ..ops.cfconv import (CFConvParams, build_cfconv_neighbors, cfconv,
                          cfconv_from_payload, cfconv_masked, init_cfconv,
                          shifted_softplus)
from ..utils.profiling import span
from .md_path import CellListPath, species_of, with_forces

Tensor = torch.Tensor


class CFConvStack:
    """L CFConv layers over one shared neighbor list (schnet/CFConv.h:
    28-32, BenchmarkCudaCFConv.cu:105-111)."""

    def __init__(self, config: CFConvConfig, num_layers: int = 6):
        self.config = config
        self.num_layers = num_layers

    def init(self, generator: torch.Generator,
             device=None) -> Tuple[CFConvParams, ...]:
        return tuple(init_cfconv(generator, self.config, device=device)
                     for _ in range(self.num_layers))

    def __call__(self, params: Tuple[CFConvParams, ...],
                 neighbors: MaskedPairs, inputs: Tensor) -> Tensor:
        x = inputs
        for p in params:
            x = cfconv(p, neighbors, x, self.config)
        return x

    def apply_payload(self, params: Tuple[CFConvParams, ...], payload,
                      inputs: Tensor, chunk_size=None, compute_dtype=None,
                      custom_adjoint: bool = True) -> Tensor:
        """The stack over a cell-list neighbor payload (one payload build
        serves all layers; see ``ops.cfconv.cfconv_from_payload``)."""
        x = inputs
        for p in params:
            x = cfconv_from_payload(p, payload, x, self.config, chunk_size,
                                    compute_dtype=compute_dtype,
                                    custom_adjoint=custom_adjoint)
        return x

    def apply_distances(self, params: Tuple[CFConvParams, ...],
                        distances: Tensor, indices: Tensor, mask: Tensor,
                        inputs: Tensor, chunk_size=None,
                        compute_dtype=None, plain: bool = False) -> Tensor:
        """The stack over an explicit (distances, indices, mask) triple:
        with ``CellList.select(build_mirror=True)`` and
        ``payload_distances_from_selection``, the scatter-free production
        path at large N (the B.6 kernel runs each layer's backward; ``plain``
        its plain version, on any device)."""
        x = inputs
        for p in params:
            x = cfconv_masked(p, distances, mask, indices, x, self.config,
                              chunk_size, compute_dtype=compute_dtype,
                              plain=plain)
        return x


def conv_chunk(num_atoms: int) -> Optional[int]:
    """Atom rows a chunk of the conv's plain forward and backward take
    (the card's kernels take all rows at once): 2048 above 4096 atoms
    (bounding their [rows, K, width] temporaries), else one chunk."""
    return 2048 if num_atoms > 4096 else None


class DenseParams(NamedTuple):
    w: Tensor
    b: Tensor


class InteractionParams(NamedTuple):
    atomwise_in: DenseParams     # width -> width (pre-conv mixing)
    conv: CFConvParams
    atomwise_out1: DenseParams   # width -> width, ssp
    atomwise_out2: DenseParams   # width -> width (residual update)


class SchNetParams(NamedTuple):
    embedding: Tensor                    # [num_species, width]
    interactions: Tuple[InteractionParams, ...]
    readout1: DenseParams                # width -> width//2, ssp
    readout2: DenseParams                # width//2 -> 1


def _dense(p: DenseParams, x: Tensor) -> Tensor:
    return x @ p.w + p.b


@dataclasses.dataclass(frozen=True)
class SchNetModel(CellListPath):
    """SchNet potential: embedding + L interaction blocks + atomwise
    readout.

    Built with :meth:`from_atomic_numbers` it also holds its atoms'
    species, and runs on the cell list's MD path."""
    config: CFConvConfig
    num_species: int
    num_interactions: int = 3
    species: Tuple[int, ...] = ()

    @classmethod
    def from_atomic_numbers(cls, atomic_numbers, config: CFConvConfig,
                            elements, num_interactions: int = 6
                            ) -> 'SchNetModel':
        """The model of one system: species ``elements.index(z)`` for each
        atomic number."""
        species, num_species = species_of(atomic_numbers, elements)
        return cls(config, num_species, num_interactions, species)

    def init(self, generator: torch.Generator, device=None) -> SchNetParams:
        """Random parameters drawn with ``generator`` (fan-in scaled
        normals, zero biases, a unit-normal embedding) on ``device`` (the
        card unless the caller says otherwise)."""
        dev = resolve_device(device)

        def normal(*shape):
            return torch.randn(*shape, generator=generator,
                               device=generator.device).to(dev)

        def dense(n_in, n_out):
            return DenseParams(normal(n_in, n_out) / np.sqrt(n_in),
                               torch.zeros(n_out, device=dev))

        width = self.config.width
        embedding = normal(self.num_species, width)
        blocks = tuple(InteractionParams(
            atomwise_in=dense(width, width),
            conv=init_cfconv(generator, self.config, device=dev),
            atomwise_out1=dense(width, width),
            atomwise_out2=dense(width, width))
            for _ in range(self.num_interactions))
        return SchNetParams(embedding, blocks, dense(width, width // 2),
                            dense(width // 2, 1))

    def _interactions(self, params: SchNetParams, x: Tensor, conv) -> Tensor:
        """The interaction blocks on the embedded features ``x``;
        ``conv(conv_params, v)`` is the CFConv over the neighbors."""
        for block in params.interactions:
            v = _dense(block.atomwise_in, x)
            v = conv(block.conv, v)
            v = shifted_softplus(_dense(block.atomwise_out1, v))
            v = _dense(block.atomwise_out2, v)
            x = x + v                      # residual interaction update
        return x

    @staticmethod
    def _readout(params: SchNetParams, x: Tensor) -> Tensor:
        h = shifted_softplus(_dense(params.readout1, x))
        return torch.sum(_dense(params.readout2, h)[:, 0])

    def energy(self, params: SchNetParams, positions: Tensor,
               species: Tensor, box: Optional[Tensor] = None,
               max_num_pairs: int = -1) -> Tensor:
        neighbors = build_cfconv_neighbors(positions, self.config.cutoff, box,
                                           max_num_pairs)
        x = self._interactions(
            params, params.embedding.index_select(0, species.long()),
            lambda p, v: cfconv(p, neighbors, v, self.config))
        return self._readout(params, x)

    def energy_and_forces(self, params: SchNetParams, positions: Tensor,
                          species: Tensor, box: Optional[Tensor] = None,
                          max_num_pairs: int = -1) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = self.energy(params, pos, species, box, max_num_pairs)
            (grad,) = torch.autograd.grad(e, pos)
        return e.detach(), -grad

    # ---- The cell list's MD path (a model from ``from_atomic_numbers``):
    # ``create_cell_list``, ``select``, ``overflow_counts`` and
    # ``capacities`` are ``CellListPath``'s.

    def energy_and_forces_from_selection(self, params: SchNetParams,
                                         positions: Tensor, box: Tensor,
                                         cell_list: CellList,
                                         sel: SlotSelection
                                         ) -> Tuple[Tensor, Tensor]:
        """Energy and forces = -dE/dpositions against a frozen selection:
        the scatter-free distance payload, the interaction blocks with
        ``cfconv_masked`` (the B.6 kernel runs each conv's backward on the
        card; lanes past the cutoff are masked there), the readout."""
        def energy(pos):
            with span('force.distances'):
                d, idx, m = cell_list.payload_distances_from_selection(
                    pos, box, sel)
            with span('force.interaction'):
                x = self._interactions(
                    params, params.embedding.index_select(
                        0, self._species_on(pos.device)),
                    lambda p, v: cfconv_masked(p, d, m, idx, v, self.config,
                                               conv_chunk(len(self.species))))
            with span('force.readout'):
                return self._readout(params, x)
        return with_forces(energy, positions)
