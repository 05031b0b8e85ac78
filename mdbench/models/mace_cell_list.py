"""The ``mace_cell_list`` kind: the port's MACE on the cell list's MD path,
built from the configuration's values through the port's public
constructors, with the parameters of ``mace_params``.

``build(cfg, setup)`` returns the entry points the MD loop drives: the
selection (``CellList.select(build_mirror=True)``), the force call against
a frozen selection and the overflow counts, with the capacity each count
is held against.
"""
from __future__ import annotations

from types import SimpleNamespace

from mdbench import mace_params


def port_params(cfg: dict, setup):
    """``mace_params.make`` in the port's ``MACEParams``."""
    from nnpops_tpu_torch.models.mace import (InteractionParams, MACELayer,
                                              MACEParams, ProductParams)
    from nnpops_tpu_torch.models.schnet import DenseParams
    p = mace_params.make(cfg, setup.weights, setup.device)
    layers = tuple(MACELayer(
        InteractionParams(l.skip, l.up, l.radial, l.mid),
        ProductParams(l.weights, l.linear)) for l in p.layers)
    return MACEParams(p.embedding, layers, p.readout1,
                      (DenseParams(p.readout2_w1, p.readout2_b1),
                       DenseParams(p.readout2_w2, p.readout2_b2)))


def mace_model(cfg: dict, setup):
    """(model, cell list) on the setup's frame."""
    from nnpops_tpu_torch.config import MACEConfig
    from nnpops_tpu_torch.models.mace import MACEModel
    config = MACEConfig(
        channels=int(cfg['channels']), l_max=int(cfg['l_max']),
        hidden_l=int(cfg['hidden_l']), correlation=int(cfg['correlation']),
        num_radial=int(cfg['radial']), cutoff_p=int(cfg['cutoff_p']),
        cutoff=float(cfg['cutoff']), radial_mlp=tuple(cfg['radial_mlp']),
        readout_hidden=int(cfg['readout_hidden']),
        avg_num_neighbors=float(cfg['avg_num_neighbors']))
    model = MACEModel.from_atomic_numbers(
        setup.atomic_numbers, config, cfg['elements'],
        num_interactions=int(cfg['interactions']))
    return model, model.create_cell_list(setup.frame_box, skin=cfg['skin'])


def build(cfg: dict, setup):
    model, cells = mace_model(cfg, setup)
    params = port_params(cfg, setup)
    box = setup.box
    return SimpleNamespace(
        select=lambda pos: model.select(pos, box, cells),
        force=lambda sel, pos: model.energy_and_forces_from_selection(
            params, pos, box, cells, sel),
        counts=lambda sel, pos: model.overflow_counts(pos, box, cells, sel),
        capacities=model.capacities(cells))
