"""The essential work of one force evaluation, counted from the problem,
and the least time it needs on the card.

Only interactions inside the cutoffs count, never padded lanes or tested
pairs, so the count is the same whatever kernel implements it. Each class
of work runs at its own published peak (``peaks.json``); the least time is
the largest of the classes' times, a lower bound that no implementation
can beat, since the classes could at best overlap.

Operations per interaction (an FMA counts two; a sqrt, exp, log, sin or
cos is one special-function operation):

* ANI radial, per directed pair inside Rcr (16 shifts): 110 FP32 forward,
  190 backward, 17 special each way.
* ANI angular, per triple (a center and an unordered pair of neighbors
  inside Rca; 8 x 4 terms): 172 FP32 forward, 341 backward, 18 special
  each way.
* Ensemble: every atom through its species' network, for every model, 2
  FLOP a multiply-add, forward and input gradient alike, on the bf16
  tensor cores.
* PME direct, per unordered pair inside the cutoff: 28 FP32 forward, 48
  backward, 3 special each way.
* PME spread and interpolation, per atom at order n: the three axes'
  splines (3 n^2 each way) and n^3 grid points, 3 operations each
  forward (two products and the sum) and 12 backward (the three force
  components); the grid's two FFTs, 5 K log2 K each (K grid points), and
  the convolution, 10 a point.
* Bytes: positions, charges and the used species' weights read once, the
  forces and the energy written once.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / 'peaks.json').read_text())

RAD_FWD, RAD_BWD, RAD_SFU = 110, 190, 17
ANG_FWD, ANG_BWD, ANG_SFU = 172, 341, 18
PME_FWD, PME_BWD, PME_SFU = 28, 48, 3
SPREAD_POINT_FWD, SPREAD_POINT_BWD = 3, 12
FFT_POINT = 10


def network_macs(aev_length: int, dims) -> int:
    """Multiply-adds of one atom through one model: aev -> dims -> 1."""
    full = [aev_length, *dims, 1]
    return sum(a * b for a, b in zip(full[:-1], full[1:]))


def ani_work(cfg: dict, counts: dict) -> dict:
    """Work classes of one ANI force evaluation: FP32 and special
    operations of the AEV, bf16 tensor FLOP of the ensemble, bytes."""
    per_species = counts['atoms_per_species']
    macs = sum(n * network_macs(cfg['aev_length'], cfg['layer_dims'][s])
               for s, n in enumerate(per_species))
    tensor = 2 * 2 * cfg['num_models'] * macs
    rad, ang = counts['radial_pairs'], counts['angular_triples']
    fp32 = rad * (RAD_FWD + RAD_BWD) + ang * (ANG_FWD + ANG_BWD)
    sfu = 2 * (rad * RAD_SFU + ang * ANG_SFU)
    weights = sum(2 * cfg['num_models'] * network_macs(
        cfg['aev_length'], cfg['layer_dims'][s])
        for s, n in enumerate(per_species) if n)
    atoms = sum(per_species)
    return {'tensor_bf16': tensor, 'fp32': fp32, 'sfu': sfu,
            'bytes': weights + atoms * (12 + 4 + 12) + 4}


def pme_work(counts: dict) -> dict:
    """Work classes of one PME force evaluation (direct, spread,
    reciprocal, interpolation)."""
    n, order = counts['pme_atoms'], counts['pme_order']
    points = math.prod(counts['pme_grid'])
    per_atom = (2 * 3 * order * order
                + order ** 3 * (SPREAD_POINT_FWD + SPREAD_POINT_BWD))
    fft = 2 * 5 * points * math.log2(points) + FFT_POINT * points
    pairs = counts['pme_pairs']
    return {'fp32': pairs * (PME_FWD + PME_BWD) + n * per_atom + fft,
            'sfu': 2 * pairs * PME_SFU, 'bytes': 4 * n}


def add(*works: dict) -> dict:
    out = {}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0) + v
    return out


RATES = {'tensor_bf16': 'bf16_tensor_flops', 'fp32': 'fp32_flops',
         'sfu': 'sfu_ops', 'bytes': 'hbm_bytes'}


def class_times(work: dict) -> dict:
    """Seconds of each class at its peak."""
    return {k: v / PEAKS[RATES[k]] for k, v in work.items()}


def least_time(work: dict) -> float:
    """The least seconds the work needs: its slowest class at peak."""
    return max(class_times(work).values())
