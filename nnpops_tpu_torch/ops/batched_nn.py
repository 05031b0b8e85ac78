"""Species-wise atomic-network MLP ensembles (port of
``nnpops_tpu.ops.batched_nn``).

An MD system's species are static, so atoms are permuted into contiguous
per-species row blocks once; each species' ensemble layer is then one real
matmul. ``weights[l]`` is ``[models, out_l, in_l]`` (torch Linear layout
stacked over models), ``biases[l]`` is ``[models, out_l]``.

``apply_species_net`` is the PyTorch reference of the JAX XLA path, f32 or
bf16 (bf16 operands with f32 accumulation, activations rounded to bf16
between layers, bf16 cotangents in the backward matmuls). The fused kernel
of ``ops.cuda_nn`` has its own working types. ``batched_linear``,
``pad_ensemble`` and ``apply_padded_ensemble`` are the reference's padded
per-atom layout (BatchedNN), kept for API parity and as a cross-check.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

CELU_ALPHA = 0.1


def celu(x: torch.Tensor, alpha: float = CELU_ALPHA) -> torch.Tensor:
    """CELU activation with the ANI alpha = 0.1.

    On a bf16 tensor it runs JAX's ``jax.nn.celu`` op by op in bf16,
    ``max(x, 0) + alpha * expm1(min(x, 0) / alpha)`` with alpha rounded to
    bf16, as the JAX package's bf16 ensemble does (and so does its
    gradient). ``F.celu`` rounds once and keeps alpha exact: on methanol
    that moved the bf16 forces by 5.8e-3 of the largest one."""
    if x.dtype != torch.bfloat16:
        return torch.nn.functional.celu(x, alpha=alpha)
    a16 = float(torch.tensor(alpha, dtype=torch.bfloat16))
    zero = x.new_zeros(())
    return (torch.maximum(x, zero)
            + a16 * torch.expm1(torch.minimum(x, zero) / a16))


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


def _index(a, device: torch.device) -> torch.Tensor:
    """An int64 index tensor on ``device``; a tensor already there is used
    as it is (a host-to-device copy inside a step would synchronise it)."""
    if isinstance(a, torch.Tensor) and a.device == device:
        return a.long()
    return torch.as_tensor(np.asarray(a), device=device).long()


def atomic_energies_grouped(params: EnsembleParams, aev: torch.Tensor,
                            grouping: SpeciesGrouping,
                            compute_dtype: Optional[torch.dtype] = None,
                            ) -> torch.Tensor:
    """Per-atom ensemble-mean energies, [N], in the original atom order.
    ``grouping.order`` and ``.inverse`` may be numpy arrays or index tensors
    on ``aev``'s device."""
    gathered = aev.index_select(0, _index(grouping.order, aev.device))
    pieces = []
    start = 0
    for s, count in enumerate(grouping.counts):
        if count == 0:
            continue
        pieces.append(apply_species_net(params.networks[s],
                                        gathered[start:start + count],
                                        compute_dtype))
        start += count
    per_atom = torch.mean(torch.cat(pieces), -1)
    return per_atom.index_select(0, _index(grouping.inverse, aev.device))


def ensemble_energy(params: EnsembleParams, aev: torch.Tensor,
                    grouping: SpeciesGrouping,
                    compute_dtype: Optional[torch.dtype] = None,
                    ) -> torch.Tensor:
    """Total NN energy: the sum over atoms of the model-mean atomic
    energy."""
    return torch.sum(atomic_energies_grouped(params, aev, grouping,
                                             compute_dtype))


# ---------------------------------------------------------------------------
# The reference's padded per-atom layout (BatchedNN).


def batched_linear(x: torch.Tensor, weights: torch.Tensor,
                   biases: torch.Tensor) -> torch.Tensor:
    """The BatchedLinear op ``matmul(W, x) + b`` with per-atom, per-model
    weights. x: [mols, atoms, models, in, 1]; weights: [1, atoms, models,
    out, in]; biases: [1, atoms, models, out, 1] -> [mols, atoms, models,
    out, 1]. Differentiable in every operand."""
    return torch.matmul(weights, x) + biases


def pad_ensemble(params: EnsembleParams, species
                 ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """The grouped parameters expanded to the reference's zero-padded
    per-atom layout, per layer ``([1, atoms, models, max_out, max_in],
    [1, atoms, models, max_out, 1])``."""
    species = [int(s) for s in np.asarray(species)]
    out = []
    for layer in range(len(params.networks[0].weights)):
        max_out = max(net.weights[layer].shape[1] for net in params.networks)
        max_in = max(net.weights[layer].shape[2] for net in params.networks)
        ws, bs = [], []
        for s in species:
            w = params.networks[s].weights[layer]
            b = params.networks[s].biases[layer]
            ws.append(torch.nn.functional.pad(
                w, (0, max_in - w.shape[2], 0, max_out - w.shape[1])))
            bs.append(torch.nn.functional.pad(b, (0, max_out - b.shape[1])))
        out.append((torch.stack(ws)[None], torch.stack(bs)[None][..., None]))
    return tuple(out)


def apply_padded_ensemble(padded_layers, aev: torch.Tensor) -> torch.Tensor:
    """Evaluate the padded layout as the reference's BatchedNN does.
    aev: [mols, atoms, features] -> energies [mols]."""
    x = aev[:, :, None, :, None]
    for i, (w, b) in enumerate(padded_layers):
        x = batched_linear(x, w, b)
        if i < len(padded_layers) - 1:
            x = celu(x)
    return torch.sum(x, (1, 2, 3, 4)) / x.shape[2]
