"""The ``schnet_cell_list`` kind: the port's SchNet on the cell list's MD
path, built from the configuration's values through the port's public
constructors, with the parameters of ``schnet_params``.

``build(cfg, setup)`` returns the entry points the MD loop drives: the
selection (``CellList.select(build_mirror=True)``), the force call against
a frozen selection and the overflow counts, with the capacity each count
is held against.
"""
from __future__ import annotations

from types import SimpleNamespace

from mdbench import schnet_params


def port_params(cfg: dict, setup):
    """``schnet_params.make`` in the port's ``SchNetParams``."""
    from nnpops_tpu_torch.models.schnet import (DenseParams,
                                                InteractionParams,
                                                SchNetParams)
    from nnpops_tpu_torch.ops.cfconv import CFConvParams
    p = schnet_params.make(cfg, setup.weights, setup.device)
    blocks = tuple(InteractionParams(
        DenseParams(b.in2f, b.in2f.new_zeros(b.in2f.shape[1])),
        CFConvParams(b.w1, b.b1, b.w2, b.b2),
        DenseParams(b.f2out_w, b.f2out_b), DenseParams(b.dense_w, b.dense_b))
        for b in p.blocks)
    return SchNetParams(p.embedding, blocks,
                        DenseParams(p.readout1_w, p.readout1_b),
                        DenseParams(p.readout2_w, p.readout2_b))


def schnet_model(cfg: dict, setup):
    """(model, cell list) on the setup's frame."""
    from nnpops_tpu_torch.config import CFConvConfig
    from nnpops_tpu_torch.models.schnet import SchNetModel
    g, rc = int(cfg['gaussians']), float(cfg['cutoff'])
    config = CFConvConfig(width=int(cfg['width']), num_gaussians=g,
                          cutoff=rc, gaussian_width=rc / (g - 1))
    model = SchNetModel.from_atomic_numbers(
        setup.atomic_numbers, config, cfg['elements'],
        num_interactions=int(cfg['interactions']))
    return model, model.create_cell_list(setup.frame_box, skin=cfg['skin'])


def build(cfg: dict, setup):
    model, cells = schnet_model(cfg, setup)
    params = port_params(cfg, setup)
    box = setup.box
    return SimpleNamespace(
        select=lambda pos: model.select(pos, box, cells),
        force=lambda sel, pos: model.energy_and_forces_from_selection(
            params, pos, box, cells, sel),
        counts=lambda sel, pos: model.overflow_counts(pos, box, cells, sel),
        capacities=model.capacities(cells))
