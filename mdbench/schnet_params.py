"""SchNet's parameters for the ``schnet_cell_list`` kind, made from the
run's seed.

The harness draws one network from ``--seed`` (``inputs.make_weights``
with the configuration's ``layer_dims`` [[64]], ``aev_length`` 128 and
``num_models`` 1): exactly SchNet's readout, width -> width / 2 -> 1.
Every other parameter is drawn here, on the host, from a generator seeded
by ``inputs.sub_seed`` of a 64-bit digest of that draw, so it follows
``--seed`` too: the embedding as unit normals (SchNetPack's
``nn.Embedding``), every dense weight as normals over the square root of
its fan-in, every bias zero. The program's kind
(``models/schnet_cell_list.py``) and the plain reference
(``reference/schnet_cell_list.py``) both call :func:`make`; it imports
neither. Weights are in the ``[in, out]`` layout (``x @ w``).
"""
from __future__ import annotations

import hashlib
import math
from typing import NamedTuple, Tuple

import torch

from mdbench import inputs

Tensor = torch.Tensor
TAG = 5            # sub_seed purpose (inputs.py takes 1-3, harness.py 4)


class Block(NamedTuple):
    """One interaction: ``in2f`` [W, W] (no bias); the filter network w1
    [G, W], b1 [W], w2 [W, W], b2 [W]; ``f2out`` (ssp) and ``dense``, [W,
    W] and [W] each."""
    in2f: Tensor
    w1: Tensor
    b1: Tensor
    w2: Tensor
    b2: Tensor
    f2out_w: Tensor
    f2out_b: Tensor
    dense_w: Tensor
    dense_b: Tensor


class Params(NamedTuple):
    """The embedding [species, W], the blocks, and the readout: [W, W/2],
    [W/2] (ssp), [W/2, 1], [1]."""
    embedding: Tensor
    blocks: Tuple[Block, ...]
    readout1_w: Tensor
    readout1_b: Tensor
    readout2_w: Tensor
    readout2_b: Tensor


def digest(weights) -> int:
    """A 64-bit digest of the harness's draw (every tensor's float32 bytes,
    in order)."""
    h = hashlib.blake2b(digest_size=8)
    for net in weights:
        for t in net.weights + net.biases:
            h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return int.from_bytes(h.digest(), 'little')


def make(cfg: dict, weights, device) -> Params:
    """Every parameter of the configuration's SchNet on ``device``."""
    w, g = int(cfg['width']), int(cfg['gaussians'])
    gen = torch.Generator().manual_seed(inputs.sub_seed(digest(weights), TAG))

    def normal(*shape):
        return (torch.randn(shape, generator=gen)
                / math.sqrt(shape[0])).to(device)

    def zeros():
        return torch.zeros(w, device=device)

    embedding = torch.randn((len(cfg['elements']), w), generator=gen).to(
        device)
    blocks = tuple(Block(normal(w, w), normal(g, w), zeros(), normal(w, w),
                         zeros(), normal(w, w), zeros(), normal(w, w),
                         zeros())
                   for _ in range(int(cfg['interactions'])))
    net = weights[0]
    (r1, r2), (b1, b2) = net.weights, net.biases
    return Params(embedding, blocks, r1[0].t().contiguous(), b1[0].clone(),
                  r2[0].t().contiguous(), b2[0].clone())
