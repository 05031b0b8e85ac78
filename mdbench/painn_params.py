"""PaiNN's parameters for the ``painn_cell_list`` kind, made from the run's
seed.

The harness draws one network from ``--seed`` (``inputs.make_weights``
with the configuration's ``layer_dims`` [[64]], ``aev_length`` 128 and
``num_models`` 1): exactly PaiNN's readout, width -> width / 2 -> 1. Every
other parameter is drawn here, on the host, from a generator seeded by
``inputs.sub_seed`` of a 64-bit digest of that draw
(``schnet_params.digest``), so it follows ``--seed`` too: the embedding as
unit normals (SchNetPack's ``nn.Embedding``), every dense weight as
SchNetPack's ``Dense`` draws it, Glorot uniform (the filter layer with the
fan-out of SchNetPack's one filter layer, 3F x blocks), every bias as
normals times the configuration's ``bias_scale`` (not SchNetPack's zeros,
so that a bias wired wrongly shows). The program's kind (``models/painn_cell_list.py``) and the plain
reference (``reference/painn_cell_list.py``) both call :func:`make`; it
imports neither. Weights are in the ``[in, out]`` layout (``x @ w``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from mdbench import inputs
from mdbench.schnet_params import digest

Tensor = torch.Tensor
TAG = 6            # sub_seed purpose (inputs.py 1-3, harness.py 4, SchNet 5)


class Block(NamedTuple):
    """One message and update: phi [F, F] + [F] (SiLU), [F, 3F] + [3F];
    the filter [R, 3F] + [3F]; (U | V) [F, 2F], no bias; the update's
    context net [2F, F] + [F] (SiLU), [F, 3F] + [3F]."""
    phi1_w: Tensor
    phi1_b: Tensor
    phi2_w: Tensor
    phi2_b: Tensor
    filter_w: Tensor
    filter_b: Tensor
    uv: Tensor
    a1_w: Tensor
    a1_b: Tensor
    a2_w: Tensor
    a2_b: Tensor


class Params(NamedTuple):
    """The embedding [species, F], the blocks, and the readout: [F, F/2],
    [F/2] (SiLU), [F/2, 1], [1]."""
    embedding: Tensor
    blocks: Tuple[Block, ...]
    readout1_w: Tensor
    readout1_b: Tensor
    readout2_w: Tensor
    readout2_b: Tensor


def make(cfg: dict, weights, device) -> Params:
    """Every parameter of the configuration's PaiNN on ``device``."""
    f, r = int(cfg['width']), int(cfg['radial'])
    scale = float(cfg['bias_scale'])
    gen = torch.Generator().manual_seed(inputs.sub_seed(digest(weights), TAG))

    def glorot(n_in, n_out, fan_out=None):
        bound = math.sqrt(6.0 / (n_in + (fan_out or n_out)))
        return ((2.0 * torch.rand((n_in, n_out), generator=gen) - 1.0)
                * bound).to(device)

    def bias(n):
        return (scale * torch.randn(n, generator=gen)).to(device)

    embedding = torch.randn((len(cfg['elements']), f), generator=gen).to(
        device)
    blocks_n = int(cfg['interactions'])
    blocks = tuple(Block(glorot(f, f), bias(f), glorot(f, 3 * f),
                         bias(3 * f), glorot(r, 3 * f, 3 * f * blocks_n),
                         bias(3 * f), glorot(f, 2 * f), glorot(2 * f, f),
                         bias(f), glorot(f, 3 * f), bias(3 * f))
                   for _ in range(blocks_n))
    net = weights[0]
    (r1, r2), (b1, b2) = net.weights, net.biases
    return Params(embedding, blocks, r1[0].t().contiguous(), b1[0].clone(),
                  r2[0].t().contiguous(), b2[0].clone())
