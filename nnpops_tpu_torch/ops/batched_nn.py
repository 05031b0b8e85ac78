"""Species-wise atomic-network MLP ensembles (port of
``nnpops_tpu.ops.batched_nn``, the parts this slice needs).

An MD system's species are static, so atoms are permuted into contiguous
per-species row blocks once; each species' ensemble layer is then one real
matmul. ``weights[l]`` is ``[models, out_l, in_l]`` (torch Linear layout
stacked over models), ``biases[l]`` is ``[models, out_l]``.

``apply_species_net`` is the PyTorch reference of the JAX XLA path, f32 or
bf16 (bf16 operands with f32 accumulation, activations rounded to bf16
between layers, bf16 cotangents in the backward matmuls). The fused kernel
of ``ops.cuda_nn`` has its own working types.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

CELU_ALPHA = 0.1


def celu(x: torch.Tensor, alpha: float = CELU_ALPHA) -> torch.Tensor:
    """CELU activation with the ANI alpha = 0.1."""
    return torch.nn.functional.celu(x, alpha=alpha)


class SpeciesNet(NamedTuple):
    """Stacked ensemble weights for one species:
    weights[l] [models, out_l, in_l]; biases[l] [models, out_l]."""
    weights: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]


class EnsembleParams(NamedTuple):
    """Per-species ensemble networks (index = species id)."""
    networks: Tuple[SpeciesNet, ...]

    @property
    def num_models(self) -> int:
        return self.networks[0].weights[0].shape[0]


def resolve_device(device=None) -> torch.device:
    """The device an entry point makes its tensors on: the CUDA card unless
    the caller asks for another device (``device='cpu'``). Raises when the
    card is asked for and there is none."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'nnpops_tpu_torch: no CUDA device is available; the entry points '
            "run on the card unless the caller passes device='cpu'")
    return device


def init_ensemble(generator: torch.Generator, aev_length: int,
                  layer_dims: Sequence[Sequence[int]], num_models: int,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> EnsembleParams:
    """Random-init an ensemble (He-style fan-in scaling, as the JAX init)
    for each species: aev -> h1 -> ... -> hk -> 1. ``generator`` draws on
    its own device; the tensors then move to ``device`` (the CUDA card by
    default, see :func:`resolve_device`). The numbers differ from
    ``jax.random``'s; tests carry JAX params across instead."""
    device = resolve_device(device)
    nets = []
    for dims in layer_dims:
        full = [aev_length, *dims, 1]
        ws, bs = [], []
        for i in range(len(full) - 1):
            w = torch.randn(num_models, full[i + 1], full[i],
                            generator=generator, dtype=dtype,
                            device=generator.device) / np.sqrt(full[i])
            ws.append(w.to(device))
            bs.append(torch.zeros(num_models, full[i + 1], dtype=dtype,
                                  device=device))
        nets.append(SpeciesNet(tuple(ws), tuple(bs)))
    return EnsembleParams(tuple(nets))


class _DotBF16(torch.autograd.Function):
    """``a @ b`` with both passes on bf16 operands and f32 accumulation (the
    JAX ``_dot_bf16``/``_batched_dot_bf16`` contract: cotangents are rounded
    to bf16 before the backward matmuls). Works batched."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
        ctx.save_for_backward(a16, b16)
        return a16 @ b16

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16).float()
        return g16 @ b16.transpose(-1, -2), a16.transpose(-1, -2) @ g16


def apply_species_net(net: SpeciesNet, x: torch.Tensor,
                      compute_dtype: Optional[torch.dtype] = None,
                      ) -> torch.Tensor:
    """Run one species' ensemble: ``x [n, aev] -> energies [n, models]``.
    ``compute_dtype=torch.bfloat16`` takes the bf16 contract of the JAX
    path; None is f32 throughout."""
    bf16 = compute_dtype == torch.bfloat16

    def dot(a, b):
        return _DotBF16.apply(a, b) if bf16 else a @ b

    h = x[None]                                         # [1, n, in]
    num_layers = len(net.weights)
    for layer in range(num_layers):
        w, b = net.weights[layer], net.biases[layer]
        h = dot(h, w.transpose(1, 2)) + b[:, None, :]   # [m, n, out]
        if layer < num_layers - 1:
            if bf16:
                h = celu(h.to(torch.bfloat16)).float()
            else:
                h = celu(h)
    return h[:, :, 0].T                                 # [n, models]


class SpeciesGrouping(NamedTuple):
    """Static atom-to-species-block permutation, built once per system."""
    order: np.ndarray            # [N] atom indices sorted by species
    counts: Tuple[int, ...]      # atoms per species (static Python ints)
    inverse: np.ndarray          # [N] inverse permutation


def build_grouping(species: np.ndarray, num_species: int) -> SpeciesGrouping:
    species = np.asarray(species)
    order = np.argsort(species, kind='stable').astype(np.int32)
    counts = tuple(int((species == s).sum()) for s in range(num_species))
    inverse = np.empty_like(order)
    inverse[order] = np.arange(len(order), dtype=np.int32)
    return SpeciesGrouping(order, counts, inverse)


def ensemble_energy_grouped_rows(params: EnsembleParams, aev: torch.Tensor,
                                 counts: Sequence[int],
                                 compute_dtype: Optional[torch.dtype] = None,
                                 ) -> torch.Tensor:
    """Total NN energy when the AEV rows are already species-grouped
    (``counts[s]`` contiguous rows per species, ascending species)."""
    total = aev.new_zeros(())
    start = 0
    for s, count in enumerate(counts):
        if count == 0:
            continue
        e = apply_species_net(params.networks[s], aev[start:start + count],
                              compute_dtype)
        total = total + torch.sum(torch.mean(e, -1))
        start += count
    return total
