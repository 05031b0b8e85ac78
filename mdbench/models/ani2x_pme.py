"""The ``ani2x_pme`` kind: BASELINE config 5, the port's ANI-2x window
path plus PME (window direct kernel, ``index_add`` spread and ``rfftn``
reciprocal), built from the configuration's values through the port's
public constructors (``ops.pme.PME``, ``models.combined.ANIWithPME``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from mdbench.models.ani2x_window import ani_model


def build(cfg: dict, setup):
    from nnpops_tpu_torch.models.combined import ANIWithPME
    from nnpops_tpu_torch.ops.pme import PME
    ani, cells, params = ani_model(cfg, setup)
    p = cfg['pme']
    n = len(setup.atomic_numbers)
    pme = PME(*setup.pme_grid, p['order'], p['alpha'], p['coulomb'],
              np.full((n, 1), -1, np.int32), device=setup.device)
    model = ANIWithPME.create(ani, pme, p['cutoff'],
                              positions=setup.frame_positions,
                              box=setup.frame_box, margin=p['window_margin'])
    if model.pme_window_plan is None:
        raise ValueError('no PME window plan fits the box')
    box, charges = setup.box, setup.charges
    return SimpleNamespace(
        select=lambda pos: model.select(pos, box, cells),
        force=lambda sel, pos: model.energy_and_forces_from_selection(
            params, pos, charges, box, cells, sel),
        counts=lambda sel, pos: model.overflow_counts(pos, charges, box,
                                                      cells, sel),
        capacities=model.capacities(cells))
