"""The ``ani2x_window`` kind: the port's ANI-2x on its production window
path, built from the configuration's values through the port's public
constructors.

``build(cfg, setup)`` returns the entry points the MD loop drives: the
selection, the force call against a frozen selection and the overflow
counts, with the capacity each count is held against.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch


def basis_of(cfg: dict):
    from nnpops_tpu_torch.config import ANIBasis
    a = cfg['aev']
    return ANIBasis.from_grids(int(cfg['species']), a['Rcr'], a['Rca'],
                               EtaR=a['EtaR'], ShfR=a['ShfR'],
                               EtaA=a['EtaA'], Zeta=a['Zeta'],
                               ShfA=a['ShfA'], ShfZ=a['ShfZ'])


def ani_model(cfg: dict, setup):
    """(model, cell list, params) of the window path on the setup's frame."""
    from nnpops_tpu_torch.models.ani import ANIModel, ANIParams
    from nnpops_tpu_torch.ops.batched_nn import EnsembleParams, SpeciesNet
    model = ANIModel.from_atomic_numbers(
        setup.atomic_numbers, basis_of(cfg), elements=cfg['elements'],
        nn_dtype=cfg['nn_dtype'], nn_impl=cfg['nn_impl']).with_blocked_layout(
            setup.frame_positions, setup.frame_box, margin=cfg['margin'],
            impl=cfg['impl'], skin=cfg['skin'])
    if model.aev_impl != cfg['impl']:
        raise ValueError(f"the {cfg['impl']} layout fell back to "
                         f'{model.aev_impl}')
    cells = model.create_cell_list(setup.frame_box, skin=cfg['skin'])
    params = ANIParams(
        EnsembleParams(tuple(SpeciesNet(w.weights, w.biases)
                             for w in setup.weights)),
        torch.tensor(cfg['self_energies'], dtype=torch.float32,
                     device=setup.device))
    return model, cells, params


def build(cfg: dict, setup):
    model, cells, params = ani_model(cfg, setup)
    box = setup.box
    return SimpleNamespace(
        select=lambda pos: model.select(pos, box, cells),
        force=lambda sel, pos: model.energy_and_forces_from_selection(
            params, pos, box, cells, sel),
        counts=lambda sel, pos: model.overflow_counts(pos, box, cells, sel),
        capacities=model._capacities(cells))
