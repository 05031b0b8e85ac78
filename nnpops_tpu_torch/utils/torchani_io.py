"""TorchANI parameter import and export (port of
``nnpops_tpu.utils.torchani_io``).

Trained ANI parameters travel as a ``.npz`` with the JAX package's naming
scheme, so a file written by either package loads in the other:

    num_species, num_models, num_layers : int scalars
    w_s{S}_m{M}_l{L} : [out, in] float32   (torch Linear.weight layout)
    b_s{S}_m{M}_l{L} : [out] float32
    self_energies    : [num_species] float32 (optional)

:func:`export_torchani_npz` runs where ``torchani`` is installed;
:func:`import_torch_state_dict` converts a plain state dict of
per-species ``torch.nn.Sequential`` networks.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.batched_nn import EnsembleParams, SpeciesNet, resolve_device


def save_ensemble_npz(path: str, weights, biases, self_energies=None) -> None:
    """weights[s][m][l]: [out, in] arrays or tensors; biases likewise
    [out]."""
    def host(a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float32)

    num_species = len(weights)
    num_models = len(weights[0])
    num_layers = len(weights[0][0])
    out = {'num_species': np.int32(num_species),
           'num_models': np.int32(num_models),
           'num_layers': np.int32(num_layers)}
    for s in range(num_species):
        for m in range(num_models):
            for l in range(num_layers):
                out[f'w_s{s}_m{m}_l{l}'] = host(weights[s][m][l])
                out[f'b_s{s}_m{m}_l{l}'] = host(biases[s][m][l])
    if self_energies is not None:
        out['self_energies'] = host(self_energies)
    np.savez(path, **out)


def load_ensemble_npz(path: str, device=None
                      ) -> Tuple[EnsembleParams, Optional[torch.Tensor]]:
    """Rebuild ``(EnsembleParams, self_energies)`` from the npz layout
    above, on ``device`` (the CUDA card unless the caller asks for another,
    see ``resolve_device``); ``self_energies`` is None when the file has
    none. Weights are transposed nowhere: ``SpeciesNet`` stores
    ``[models, out, in]``, the torch Linear layout stacked over models."""
    device = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=device)

    with np.load(path) as data:
        ns = int(data['num_species'])
        nm = int(data['num_models'])
        nl = int(data['num_layers'])
        nets = []
        for s in range(ns):
            ws = tuple(tensor(np.stack([data[f'w_s{s}_m{m}_l{l}']
                                        for m in range(nm)]))
                       for l in range(nl))
            bs = tuple(tensor(np.stack([data[f'b_s{s}_m{m}_l{l}']
                                        for m in range(nm)]))
                       for l in range(nl))
            nets.append(SpeciesNet(ws, bs))
        sae = (tensor(data['self_energies'])
               if 'self_energies' in data else None)
    return EnsembleParams(tuple(nets)), sae


def export_torchani_npz(path: str, model_name: str = 'ANI2x') -> None:
    """One-time exporter: run where ``torchani`` IS installed (it raises
    ``ImportError`` elsewhere).

    Extracts the ensemble's linear layers (the 0/2/4/6 structure of each
    atomic network) and the self energies into the npz layout."""
    import torchani   # noqa: F401 -- a hard dependency of this function only
    model = getattr(torchani.models, model_name)(periodic_table_index=False)
    ensemble = model.neural_networks
    models = list(ensemble) if hasattr(ensemble, '__iter__') else [ensemble]
    num_species = len(model.species_converter.conv_tensor[
        model.species_converter.conv_tensor >= 0])
    num_networks = len(list(models[0].values()))
    if num_networks != num_species:
        raise ValueError(f'converter reports {num_species} species but the '
                         f'ensemble has {num_networks} atomic networks')
    weights, biases = [], []
    for s in range(num_networks):
        w_s, b_s = [], []
        for m in models:
            seq = list(m.values())[s]
            layers = [seq[i] for i in (0, 2, 4, 6)]
            w_s.append([l.weight.detach().numpy() for l in layers])
            b_s.append([l.bias.detach().numpy() for l in layers])
        weights.append(w_s)
        biases.append(b_s)
    sae = model.energy_shifter.self_energies.detach().numpy()
    save_ensemble_npz(path, weights, biases, sae)


def import_torch_state_dict(state_dict, num_species: int, num_models: int,
                            layer_indices: Sequence[int] = (0, 2, 4, 6)):
    """Convert a flat state dict of per-species sequential networks (keys
    like ``'{model}.{species}.{layer}.weight'``) into the nested
    weights/biases lists of :func:`save_ensemble_npz` (numpy float32)."""
    weights = [[[None] * len(layer_indices) for _ in range(num_models)]
               for _ in range(num_species)]
    biases = [[[None] * len(layer_indices) for _ in range(num_models)]
              for _ in range(num_species)]
    for key, value in state_dict.items():
        parts = key.split('.')
        if parts[-1] not in ('weight', 'bias'):
            continue
        m, s, l = int(parts[0]), int(parts[1]), int(parts[2])
        li = list(layer_indices).index(l)
        arr = np.asarray(value.detach().cpu() if hasattr(value, 'detach')
                         else value, np.float32)
        if parts[-1] == 'weight':
            weights[s][m][li] = arr
        else:
            biases[s][m][li] = arr
    return weights, biases
