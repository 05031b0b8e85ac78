"""MACE's parameters for the ``mace_cell_list`` kind, made from the run's
seed.

The harness draws one network from ``--seed`` (``inputs.make_weights``
with the configuration's ``layer_dims`` [[16]], ``aev_length`` 128 and
``num_models`` 1, no biases): exactly MACE's last readout, channels -> 16
-> 1, already fan-in scaled. Every other parameter is drawn here, on the
host, from a generator seeded by ``inputs.sub_seed`` of a 64-bit digest of
that draw (``schnet_params.digest``), so it follows ``--seed`` too, as
e3nn and mace draw them: unit normals (e3nn's ``Linear``,
``FullyConnectedNet`` and ``FullyConnectedTensorProduct``, whose
1/sqrt(fan-in) constants the forward applies) and the symmetric
contraction's W_nu,L as normals / n_eta (mace's ``Contraction``). The
program's kind (``models/mace_cell_list.py``) and the plain reference
(``reference/mace_cell_list.py``) both call :func:`make`; it imports
neither. Weights are in the ``[in, out]`` layout (``x @ w``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mdbench import inputs
from mdbench.schnet_params import digest

Tensor = torch.Tensor
TAG = 7            # sub_seed purpose (inputs.py 1-3, harness.py 4, 5-6 models)
# Basis size n_eta of the symmetric contraction's U^{nu,L} on 0e + 1o + 2e
# + 3o, (nu, L) -> n (the reference builds the bases and checks these).
BASIS_SIZES = {(1, 0): 1, (2, 0): 4, (3, 0): 8,
               (1, 1): 1, (2, 1): 3, (3, 1): 12}


class Layer(NamedTuple):
    """One interaction and product: the skip [E, F, F]; up, per l of the
    input, [F, F]; the radial MLP [R, 64], [64, 64], [64, 64], [64, P F];
    the mid linear, per l3, [P_l3 F, F]; the contraction's weights, per
    output L, per nu, [E, n_eta, F]; the product's linear, per output L,
    [F, F]."""
    skip: Tensor
    up: Tuple[Tensor, ...]
    radial: Tuple[Tensor, ...]
    mid: Tuple[Tensor, ...]
    weights: Tuple[Tuple[Tensor, ...], ...]
    linear: Tuple[Tensor, ...]


class Params(NamedTuple):
    """The embedding [E, F], the layers, the linear readout of every layer
    but the last [F], and the last readout [F, 16], [16] (SiLU), [16, 1],
    [1], already fan-in scaled."""
    embedding: Tensor
    layers: Tuple[Layer, ...]
    readout1: Tensor
    readout2_w1: Tensor
    readout2_b1: Tensor
    readout2_w2: Tensor
    readout2_b2: Tensor


def paths(l_in, lmax: int = 3):
    """The tensor product's paths (l1, l2, l3) in e3nn's order."""
    return [(l1, l2, l3) for l1 in l_in for l2 in range(lmax + 1)
            for l3 in range(abs(l1 - l2), min(l1 + l2, lmax) + 1)
            if (l1 + l2 + l3) % 2 == 0]


def layer_irreps(cfg: dict, t: int):
    """(the l of layer ``t``'s input, the l of its output)."""
    hidden = tuple(range(int(cfg['hidden_l']) + 1))
    last = t == int(cfg['interactions']) - 1
    return ((0,) if t == 0 else hidden), ((0,) if last else hidden)


def make(cfg: dict, weights, device) -> Params:
    """Every parameter of the configuration's MACE on ``device``."""
    f, r = int(cfg['channels']), int(cfg['radial'])
    e = len(cfg['elements'])
    gen = torch.Generator().manual_seed(inputs.sub_seed(digest(weights), TAG))

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(device)

    embedding = normal(e, f)
    layers = []
    for t in range(int(cfg['interactions'])):
        l_in, l_out = layer_irreps(cfg, t)
        ps = paths(l_in)
        widths = (r, *cfg['radial_mlp'], len(ps) * f)
        skip = normal(e, f, f)
        up = tuple(normal(f, f) for _ in l_in)
        radial = tuple(normal(a, b) for a, b in zip(widths, widths[1:]))
        mid = tuple(normal(sum(p[2] == l for p in ps) * f, f)
                    for l in range(4))
        w = tuple(tuple(normal(e, BASIS_SIZES[nu, big_l], f)
                        / BASIS_SIZES[nu, big_l]
                        for nu in range(1, int(cfg['correlation']) + 1))
                  for big_l in l_out)
        linear = tuple(normal(f, f) for _ in l_out)
        layers.append(Layer(skip, up, radial, mid, w, linear))
    readout1 = normal(f)
    net = weights[0]
    (r1, r2), (b1, b2) = net.weights, net.biases
    return Params(embedding, tuple(layers), readout1, r1[0].t().contiguous(),
                  b1[0].clone(), r2[0].t().contiguous(), b2[0].clone())
