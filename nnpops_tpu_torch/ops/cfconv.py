"""SchNet continuous-filter convolution, CFConv (port of
``nnpops_tpu.ops.cfconv``).

Per neighbor pair: a Gaussian basis of the distance, a dense layer, shifted
softplus or tanh, a second dense layer and the cosine cutoff make the
filter; each atom's output is the sum over its neighbors of the filter
times the neighbor's input vector (schnet/CFConv.h:92-123).

Two neighbor forms:

* the half pair list (``build_cfconv_neighbors``, the O(N^2)
  ``neighbors.pairs`` enumeration): :func:`cfconv`, each pair contributing
  to both endpoints through one ``index_add``; gradients by autograd;
* a directed per-atom list (``CellList.build_payload``, or the
  ``(distances, indices, mask)`` triple of
  ``CellList.payload_distances_from_selection``, the production path for
  large periodic boxes): :func:`cfconv_from_payload` and
  :func:`cfconv_masked`, through ``ops.cuda_cfconv.PayloadConv``: on the
  card its forward is the fused kernel (``csrc/cfconv_fwd.cu``, one
  float32 pass over each row's valid lanes) and its backward the
  hand-written B.6 kernel; on the CPU both are plain PyTorch.

Weights keep the JAX ``[in, out]`` layout.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import CFConvConfig
from ..geometry import cosine_cutoff
from ..neighbors.pairs import MaskedPairs, neighbor_pairs_masked
from ..utils.profiling import COUNTERS
from .aev_blocked import device_constant
from .batched_nn import resolve_device
from .cuda_cfconv import _gather_rows, _pad_row, _row_chunks, payload_conv

Tensor = torch.Tensor

_LN2 = float(np.log(2.0))


def shifted_softplus(x: Tensor) -> Tensor:
    """``log(0.5 exp(x) + 0.5)`` = softplus(x) - log 2 (CFConv.h:115-118)."""
    return torch.nn.functional.softplus(x) - _LN2


class CFConvParams(NamedTuple):
    """Filter-network parameters in the JAX ``[in, out]`` layout: w1
    [num_gaussians, width], b1 [width], w2 [width, width], b2 [width]."""
    w1: Tensor
    b1: Tensor
    w2: Tensor
    b2: Tensor

    @classmethod
    def from_reference_layout(cls, w1, b1, w2, b2,
                              device=None) -> 'CFConvParams':
        """From the reference's ``[out, in]`` row-major weights (numpy), on
        ``device`` (the CUDA card unless the caller says otherwise)."""
        dev = resolve_device(device)

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)
        return cls(t(w1).T.contiguous(), t(b1), t(w2).T.contiguous(), t(b2))


def init_cfconv(generator: torch.Generator, config: CFConvConfig,
                dtype: torch.dtype = torch.float32,
                device=None) -> CFConvParams:
    """Random filter weights (fan-in scaled normals, zero biases), drawn on
    the generator's device, then moved to ``device`` (the card unless the
    caller says otherwise). The numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    g, w = config.num_gaussians, config.width

    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=dtype,
                           device=generator.device).to(dev)
    return CFConvParams(w1=normal(g, w) / np.sqrt(g),
                        b1=torch.zeros(w, dtype=dtype, device=dev),
                        w2=normal(w, w) / np.sqrt(w),
                        b2=torch.zeros(w, dtype=dtype, device=dev))


def build_cfconv_neighbors(positions: Tensor, cutoff: float,
                           box: Optional[Tensor] = None,
                           max_num_pairs: int = -1) -> MaskedPairs:
    """The CFConvNeighbors equivalent (schnet/CFConv.h:28-57): build once
    per position change, share across every layer."""
    return neighbor_pairs_masked(positions, cutoff, max_num_pairs, box)


def pair_filters(params: CFConvParams, distances: Tensor, mask: Tensor,
                 config: CFConvConfig) -> Tensor:
    """The per-pair filter y2 ``[..., width]``: Gaussians -> dense ->
    activation -> dense -> cosine cutoff (CpuCFConv.cpp:151-178)."""
    centers = device_constant(tuple(float(c) for c in
                                    config.gaussian_positions),
                              torch.float32, distances.device)
    x = (distances[..., None] - centers) / config.gaussian_width
    gauss = torch.exp(-0.5 * x * x)
    h = gauss @ params.w1 + params.b1
    h = shifted_softplus(h) if config.activation == 'ssp' else torch.tanh(h)
    y = h @ params.w2 + params.b2
    y = y * cosine_cutoff(distances, config.cutoff)[..., None]
    return torch.where(mask[..., None], y, 0.0)


def cfconv(params: CFConvParams, neighbors: MaskedPairs, inputs: Tensor,
           config: CFConvConfig) -> Tensor:
    """CFConv over a shared half pair list: ``inputs [N, width] -> [N,
    width]``; each pair contributes to both endpoints (CpuCFConv.cpp:
    182-185), one ``index_add`` over the doubled directed list."""
    y2 = pair_filters(params, neighbors.distances, neighbors.mask, config)
    a1, a2 = neighbors.atom1, neighbors.atom2
    messages = torch.cat([y2 * inputs.index_select(0, a2),
                          y2 * inputs.index_select(0, a1)])
    return torch.zeros_like(inputs).index_add(0, torch.cat([a1, a2]),
                                              messages)


def _conv(params, dist, mask, idx, inputs, config, chunk_size, compute_dtype,
          custom_adjoint):
    if custom_adjoint:
        return payload_conv(tuple(params), dist, mask, idx, inputs, config,
                            chunk_size, compute_dtype)
    # Plain autograd through the chunk body, recomputed in the backward
    # (torch.utils.checkpoint, the JAX package's jax.checkpoint) so the
    # [rows, K, width] filters are not kept.
    x_pad = _pad_row(inputs)

    def rows(d, m, i, xp):
        y2 = pair_filters(params, d, m, config)
        return torch.sum(y2 * _gather_rows(xp, i), 1)

    chunks = _row_chunks(inputs.shape[0], chunk_size)
    if len(chunks) == 1:
        return rows(dist, mask, idx, x_pad)
    return torch.cat([checkpoint(rows, dist[s], mask[s], idx[s], x_pad,
                                 use_reentrant=False) for s in chunks])


def cfconv_from_payload(params: CFConvParams, payload, inputs: Tensor,
                        config: CFConvConfig,
                        chunk_size: Optional[int] = None,
                        compute_dtype: Optional[torch.dtype] = None,
                        custom_adjoint: bool = True) -> Tensor:
    """CFConv over a directed per-atom neighbor payload
    (``CellList.build_payload``), the O(N) path for large periodic boxes.

    ``chunk_size``: process atom rows in blocks, bounding the [rows, K,
    width] filter tensors. ``compute_dtype=torch.bfloat16``: bf16 operands
    of the two filter products, f32 accumulation. ``custom_adjoint``
    (default True): the kernels' path (``ops.cuda_cfconv``: on the card
    the fused forward, which takes only f32, and the hand-written backward);
    False is plain autograd through the recomputed chunk body (the oracle of
    the adjoint tests; ``compute_dtype`` applies to the kernels' path only,
    as in the JAX package)."""
    n = payload.distances.shape[0]
    # Re-mask by the layer cutoff: the payload may carry a Verlet skin, and
    # the cosine cutoff rises again beyond the cutoff.
    mask = payload.mask & (payload.distances < config.cutoff)
    dist = torch.where(mask, payload.distances, 0.0)
    idx = torch.where(mask, payload.indices, n).to(torch.int32)
    return _conv(params, dist, mask, idx, inputs, config, chunk_size,
                 compute_dtype, custom_adjoint)


def cfconv_masked(params: CFConvParams, distances: Tensor, mask: Tensor,
                  indices: Tensor, inputs: Tensor, config: CFConvConfig,
                  chunk_size: Optional[int] = None,
                  compute_dtype: Optional[torch.dtype] = None,
                  plain: bool = False) -> Tensor:
    """CFConv over an explicit (distances, mask, indices) neighbor triple
    (``CellList.payload_distances_from_selection``: the production path,
    scatter-free in its position adjoint), through the kernels. The JAX
    ``bwd_impl`` selector is a TPU matter and is not carried: on the card
    the forward is the fused kernel and the backward the B.6 kernel;
    ``plain`` asks for both plain versions on any device. The lanes go
    into ``COUNTERS['cfconv_lanes']``; lanes of a Verlet skin (the
    selection's ``cutoff + skin``) are masked here, since the cosine
    cutoff rises again past the cutoff."""
    COUNTERS['cfconv_lanes'] += distances.numel()
    n = inputs.shape[0]
    m = mask & (distances < config.cutoff)
    dist = torch.where(m, distances, 0.0)
    idx = torch.where(m, indices, n).to(torch.int32)
    return payload_conv(tuple(params), dist, m, idx, inputs, config,
                        chunk_size, compute_dtype, plain)
