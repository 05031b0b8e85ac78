"""Checkpoint / resume of nested NamedTuples, tuples, lists and dicts of
tensors, MD state and parameters alike (port of the npz path of
``nnpops_tpu.md.checkpoint``).

Leaves are saved in flattening order to one ``.npz``; a
``torch.Generator`` leaf (the MD state's) is saved as its state, so a
resumed Langevin run draws the same numbers. Loading takes a template of
the same structure: shapes must match, and each leaf comes back in the
template's dtype and on its device (restore is exact, bit for bit). The
JAX package's Orbax path has no counterpart here.
"""
from __future__ import annotations

import os
from typing import Any, List

import numpy as np
import torch


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _unflatten(template: Any, leaves) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, '_fields'):
        return type(template)(*(_unflatten(t, leaves) for t in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(t, leaves) for t in template)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any) -> None:
    """Save every leaf of ``tree`` to ``path`` (.npz), atomically: a crash
    never leaves a torn checkpoint."""
    arrays = {f'leaf_{i:05d}': _to_numpy(leaf)
              for i, leaf in enumerate(_leaves(tree))}
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _restore(got: np.ndarray, want):
    if isinstance(want, torch.Generator):
        gen = torch.Generator(device=want.device)
        gen.set_state(torch.from_numpy(got.copy()))
        return gen
    shape = tuple(np.shape(want))
    if got.shape != shape:
        raise ValueError(f'leaf shape mismatch: {got.shape} vs {shape}')
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(got.copy()).to(dtype=want.dtype,
                                                device=want.device)
    return got.astype(np.asarray(want).dtype)


def load_checkpoint(path: str, template: Any) -> Any:
    """Load a checkpoint saved by :func:`save_checkpoint` into the structure
    of ``template`` (leaf count and shapes must match; raises ValueError)."""
    with np.load(path) as data:
        saved = [data[f'leaf_{i:05d}'] for i in range(len(data.files))]
    t_leaves = _leaves(template)
    if len(saved) != len(t_leaves):
        raise ValueError(f'checkpoint has {len(saved)} leaves, template has '
                         f'{len(t_leaves)}')
    restored = [_restore(g, w) for g, w in zip(saved, t_leaves)]
    return _unflatten(template, iter(restored))
