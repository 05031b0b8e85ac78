"""AEV layout helpers shared by the AEV paths (port of the parts of
``nnpops_tpu.ops.aev`` this slice needs). The dense AEV oracle
(``compute_aev``/``aev_forward``) is ROADMAP A.4."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AEV(NamedTuple):
    radial: torch.Tensor    # [N, S * R]
    angular: torch.Tensor   # [N, P * A], P = S(S+1)/2


def species_pair_index(num_species: int) -> np.ndarray:
    """Map (species_i, species_j) -> unordered-pair symmetry-function index,
    the reference's ``angularIndex`` enumeration over (i, j >= i)."""
    s = num_species
    table = np.zeros((s, s), dtype=np.int32)
    idx = 0
    for i in range(s):
        for j in range(i, s):
            table[i, j] = table[j, i] = idx
            idx += 1
    return table
