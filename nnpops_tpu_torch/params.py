"""Parameters from elsewhere: JAX parameter trees and TorchANI npz files.

``from_jax_params`` takes the JAX package's ``ANIParams`` tree after a
``jax.tree.map(np.asarray, ...)`` (or the same structure as plain nested
tuples: ``(ensemble, self_energies)`` with ``ensemble = (networks,)`` and
``networks[s] = (weights, biases)``); it needs no JAX itself.

``from_npz`` reads the npz layout written by either package's
``utils.torchani_io.save_ensemble_npz``.

``cfconv_params_from_jax`` and ``schnet_params_from_jax`` take the JAX
package's ``CFConvParams`` and ``SchNetParams`` trees the same way (numpy
leaves, or the same structure as plain tuples) and keep its ``[in, out]``
weight layout.

All put the tensors on the CUDA card unless ``device`` says otherwise
(``device='cpu'``).
"""
from __future__ import annotations

import numpy as np
import torch

from .models.ani import ANIParams
from .models.schnet import (DenseParams, InteractionParams, SchNetParams)
from .ops.batched_nn import EnsembleParams, SpeciesNet, resolve_device
from .ops.cfconv import CFConvParams
from .utils.torchani_io import load_ensemble_npz


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def from_jax_params(tree, device=None) -> ANIParams:
    """JAX ``ANIParams`` (numpy leaves) -> the port's ``ANIParams``."""
    device = resolve_device(device)
    ensemble, self_energies = tree
    (networks,) = ensemble
    nets = tuple(SpeciesNet(tuple(_tensor(w, device) for w in weights),
                            tuple(_tensor(b, device) for b in biases))
                 for weights, biases in networks)
    return ANIParams(EnsembleParams(nets), _tensor(self_energies, device))


def ani_params_to(params: ANIParams, device) -> ANIParams:
    """A copy of ``params`` on ``device`` (e.g. the CPU twin of a model's
    parameters on the card, for a reference run)."""
    nets = tuple(SpeciesNet(tuple(w.to(device) for w in net.weights),
                            tuple(b.to(device) for b in net.biases))
                 for net in params.ensemble.networks)
    return ANIParams(EnsembleParams(nets), params.self_energies.to(device))


def from_npz(path: str, device=None) -> ANIParams:
    """Load an ensemble saved in the TorchANI npz layout
    (``utils.torchani_io.load_ensemble_npz``) as ``ANIParams``; a file
    without self energies gets zeros."""
    device = resolve_device(device)
    ensemble, sae = load_ensemble_npz(path, device)
    if sae is None:
        sae = torch.zeros(len(ensemble.networks), dtype=torch.float32,
                          device=device)
    return ANIParams(ensemble, sae)


def cfconv_params_from_jax(tree, device=None) -> CFConvParams:
    """JAX ``CFConvParams`` (w1, b1, w2, b2; numpy leaves) -> the port's."""
    device = resolve_device(device)
    return CFConvParams(*(_tensor(a, device) for a in tree))


def schnet_params_from_jax(tree, device=None) -> SchNetParams:
    """JAX ``SchNetParams`` (embedding, interactions, readout1, readout2;
    numpy leaves) -> the port's."""
    device = resolve_device(device)
    embedding, interactions, readout1, readout2 = tree

    def dense(p):
        return DenseParams(*(_tensor(a, device) for a in p))

    blocks = tuple(InteractionParams(
        atomwise_in=dense(b[0]), conv=cfconv_params_from_jax(b[1], device),
        atomwise_out1=dense(b[2]), atomwise_out2=dense(b[3]))
        for b in interactions)
    return SchNetParams(_tensor(embedding, device), blocks, dense(readout1),
                        dense(readout2))
