"""The ``painn_cell_list`` kind: the port's PaiNN on the cell list's MD
path, built from the configuration's values through the port's public
constructors, with the parameters of ``painn_params``.

``build(cfg, setup)`` returns the entry points the MD loop drives: the
selection (``CellList.select(build_mirror=True)``), the force call against
a frozen selection and the overflow counts, with the capacity each count
is held against.
"""
from __future__ import annotations

from types import SimpleNamespace

from mdbench import painn_params


def port_params(cfg: dict, setup):
    """``painn_params.make`` in the port's ``PaiNNParams``."""
    from nnpops_tpu_torch.models.painn import (MessageParams, PaiNNBlock,
                                               PaiNNParams, UpdateParams)
    from nnpops_tpu_torch.models.schnet import DenseParams
    p = painn_params.make(cfg, setup.weights, setup.device)
    blocks = tuple(PaiNNBlock(
        MessageParams(DenseParams(b.phi1_w, b.phi1_b),
                      DenseParams(b.phi2_w, b.phi2_b),
                      DenseParams(b.filter_w, b.filter_b)),
        UpdateParams(b.uv, DenseParams(b.a1_w, b.a1_b),
                     DenseParams(b.a2_w, b.a2_b)))
        for b in p.blocks)
    return PaiNNParams(p.embedding, blocks,
                       DenseParams(p.readout1_w, p.readout1_b),
                       DenseParams(p.readout2_w, p.readout2_b))


def painn_model(cfg: dict, setup):
    """(model, cell list) on the setup's frame."""
    from nnpops_tpu_torch.config import PaiNNConfig
    from nnpops_tpu_torch.models.painn import PaiNNModel
    config = PaiNNConfig(width=int(cfg['width']),
                         num_radial=int(cfg['radial']),
                         cutoff=float(cfg['cutoff']))
    model = PaiNNModel.from_atomic_numbers(
        setup.atomic_numbers, config, cfg['elements'],
        num_interactions=int(cfg['interactions']))
    return model, model.create_cell_list(setup.frame_box, skin=cfg['skin'])


def build(cfg: dict, setup):
    model, cells = painn_model(cfg, setup)
    params = port_params(cfg, setup)
    box = setup.box
    return SimpleNamespace(
        select=lambda pos: model.select(pos, box, cells),
        force=lambda sel, pos: model.energy_and_forces_from_selection(
            params, pos, box, cells, sel),
        counts=lambda sel, pos: model.overflow_counts(pos, box, cells, sel),
        capacities=model.capacities(cells))
