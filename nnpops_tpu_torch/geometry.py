"""Periodic-box geometry utilities (port of ``nnpops_tpu.geometry``).

Minimum-image displacements for *reduced* triclinic boxes: the box matrix is
lower-triangular (rows a, b, c) and the cutoff is at most half the smallest
box width, so one round-based wrap per axis, in the order c, b, a, is a
valid minimum image. ``torch.round`` rounds half to even, as ``jnp.round``
does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ['box_transform', 'minimum_image', 'validate_box', 'invert_box',
           'cosine_cutoff', 'safe_norm']


def box_transform(vecs: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``vecs @ mat`` at full f32 accuracy (the package turns TF32 off)."""
    return torch.matmul(vecs, mat)


def minimum_image(delta: torch.Tensor,
                  box: Optional[torch.Tensor]) -> torch.Tensor:
    """Wrap displacement vectors ``[..., 3]`` into the minimum image (c, then
    b, then a — the reference's order, valid for reduced boxes)."""
    if box is None:
        return delta
    delta = delta - torch.round(delta[..., 2:3] / box[2, 2]) * box[2]
    delta = delta - torch.round(delta[..., 1:2] / box[1, 1]) * box[1]
    delta = delta - torch.round(delta[..., 0:1] / box[0, 0]) * box[0]
    return delta


def validate_box(box, cutoff: float) -> None:
    """Host-side validation of reduced-form box vectors (the reference's
    getNeighborPairsCPU.cpp:40-48 checks): reduced lower-triangular form and
    every width at least twice the cutoff. Raises ValueError."""
    if isinstance(box, torch.Tensor):
        box = box.detach().cpu().numpy()
    v = np.asarray(box, dtype=np.float64)
    if v.shape != (3, 3):
        raise ValueError('box_vectors must have shape (3, 3)')
    c = float(cutoff)
    if v[0][1] != 0 or v[0][2] != 0 or v[1][2] != 0:
        raise ValueError('Invalid box vectors: not in reduced form '
                         '(a[1], a[2], b[2] must be zero)')
    if v[0][0] < 2 * c or v[1][1] < 2 * c or v[2][2] < 2 * c:
        raise ValueError('Invalid box vectors: every box width must be >= 2*cutoff')
    if v[0][0] < 2 * v[1][0] or v[0][0] < 2 * v[2][0] or v[1][1] < 2 * v[2][1]:
        raise ValueError('Invalid box vectors: not in reduced form '
                         '(a[0] >= 2*b[0], a[0] >= 2*c[0], b[1] >= 2*c[1] required)')


def invert_box(box: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a reduced lower-triangular box matrix:
    ``pos @ invert_box(box)`` gives fractional coordinates."""
    det = box[0, 0] * box[1, 1] * box[2, 2]
    scale = 1.0 / det
    zero = torch.zeros((), dtype=box.dtype, device=box.device)
    r00 = box[1, 1] * box[2, 2] * scale
    r10 = -box[1, 0] * box[2, 2] * scale
    r11 = box[0, 0] * box[2, 2] * scale
    r20 = (box[1, 0] * box[2, 1] - box[1, 1] * box[2, 0]) * scale
    r21 = -box[0, 0] * box[2, 1] * scale
    r22 = box[0, 0] * box[1, 1] * scale
    return torch.stack([torch.stack([r00, zero, zero]),
                        torch.stack([r10, r11, zero]),
                        torch.stack([r20, r21, r22])])


def cosine_cutoff(r: torch.Tensor, cutoff: float) -> torch.Tensor:
    """The ANI/SchNet cosine cutoff ``0.5*cos(pi*r/rc) + 0.5`` (valid for
    ``r <= cutoff``; callers mask beyond it)."""
    return 0.5 * torch.cos(np.pi * r / cutoff) + 0.5


def safe_norm(vec: torch.Tensor, dim: int = -1,
              eps: float = 0.0) -> torch.Tensor:
    """Norm whose gradient is finite at zero (double-where trick)."""
    sq = torch.sum(vec * vec, dim=dim)
    guarded = torch.where(sq > eps, sq, torch.ones_like(sq))
    return torch.where(sq > eps, torch.sqrt(guarded), torch.zeros_like(sq))
