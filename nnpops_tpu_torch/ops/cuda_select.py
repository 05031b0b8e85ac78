"""The window selection's compaction kernels, their wrappers and their
plain PyTorch versions: the left-pack (``csrc/left_pack.cu``) of the default
``compact_impl='kernel'``, and the validity mask and lane-index left-pack
(``csrc/window_mask.cu``) of ``compact_impl='mask'``.

Port of ``nnpops_tpu/ops/pallas_select.py`` ``make_left_pack`` (the
window selection's angular compaction). ``keys`` ``[N, W]`` int32 holds,
per species block s (lanes ``[sum(widths[:s]), sum(widths[:s+1]))``), a
candidate slot id on valid lanes and -1 on invalid ones. Per row and block,
the first ``caps[s]`` valid keys in ascending lane order are packed into
``packed[:, sum(caps[:s]):sum(caps[:s+1])]``, -1 beyond the block's count;
``counts[:, s]`` is the block's true number of valid keys (it may exceed
the cap: the overflow contract reads it).

The output order is the Pallas kernel's (ascending window lane,
stencil-entry-major), so packed lists equal the JAX package's exactly. The
Pallas kernel's f32 keys, 128-lane padding, bf16 rank matmul and VMEM
fallback are TPU means: the port takes int32 keys at their true widths.

The 'mask' compaction (ports of ``make_window_mask`` and
``make_left_pack_lanes``): :func:`window_mask` tests every (center row,
window lane) pair of a cell in slot space, ``d2 < w2`` with the static self
lane excluded, and writes a bool mask (the Pallas kernel's bf16 0/1 is a
Mosaic means); :func:`left_pack_lanes` is the left-pack keyed by the
static block-local lane index, in int32 at the true widths (the Pallas
kernel's f32 lanes, 128-lane padding and bf16 triangular rank matmul are
TPU means). ``d2`` is rounded as the 'kernel' path's PyTorch ops round it
(three products, two sums, no fused multiply-add), so both compactions
select the same pairs.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. There is no gradient (the selection is frozen).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _kernels

MAX_BLOCKS = 8      # species blocks the kernels take (csrc/left_pack.cu,
#                     csrc/window_mask.cu)
SELF_STENCIL_INDEX = 13     # stencil entry of the cell itself


def _check_widths(keys: torch.Tensor, widths, caps,
                  dtype: torch.dtype = torch.int32,
                  name: str = 'keys') -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    widths = tuple(int(w) for w in widths)
    caps = tuple(int(k) for k in caps)
    if len(widths) != len(caps):
        raise ValueError('widths and caps must align')
    if keys.dim() != 2 or keys.shape[1] != sum(widths):
        raise ValueError(f'{name} must be [N, {sum(widths)}], got '
                         f'{tuple(keys.shape)}')
    if keys.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {keys.dtype}')
    return widths, caps


def left_pack_plain(keys: torch.Tensor, widths: Sequence[int],
                    caps: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the rank of a valid lane is the cumulative sum of the
    valid mask; ranks past the cap scatter into a dropped column."""
    widths, caps = _check_widths(keys, widths, caps)
    n = keys.shape[0]
    packed, counts = [], []
    off = 0
    for w, cap in zip(widths, caps):
        k = keys[:, off:off + w]
        valid = k >= 0
        rank = torch.cumsum(valid.to(torch.int32), 1)            # 1-based
        keep = valid & (rank <= cap)
        col = torch.where(keep, rank - 1, cap).long()
        out = torch.full((n, cap + 1), -1, dtype=torch.int32, device=keys.device)
        out.scatter_(1, col, torch.where(keep, k, -1))
        packed.append(out[:, :cap])
        counts.append(valid.sum(1, dtype=torch.int32))
        off += w
    return torch.cat(packed, 1), torch.stack(counts, 1)


def left_pack_cuda(keys: torch.Tensor, widths: Sequence[int],
                   caps: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(packed [N, sum(caps)], counts [N, npres])``,
    both int32."""
    widths, caps = _check_widths(keys, widths, caps)
    if len(widths) > MAX_BLOCKS:
        raise ValueError(f'left-pack kernel takes at most {MAX_BLOCKS} blocks')
    _kernels.require_cuda(keys)
    n = keys.shape[0]
    packed = torch.empty(n, sum(caps), dtype=torch.int32, device=keys.device)
    counts = torch.empty(n, len(widths), dtype=torch.int32, device=keys.device)
    if n:
        ints = ctypes.c_int * MAX_BLOCKS
        _kernels.launch('left_pack', keys.data_ptr(), packed.data_ptr(),
                        counts.data_ptr(), n, keys.shape[1], sum(caps),
                        len(widths), ints(*widths), ints(*caps),
                        _kernels.stream_handle(keys.device))
    return packed, counts


def left_pack(keys: torch.Tensor, widths: Sequence[int],
              caps: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-pack valid keys per species block: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if keys.device.type == 'cpu':
        return left_pack_plain(keys, widths, caps)
    if keys.device.type != 'cuda':
        raise ValueError(f'no left-pack kernel for device {keys.device}')
    return left_pack_cuda(keys.contiguous(), widths, caps)


# ---------------------------------------------------------------------------
# The 'mask' compaction: validity mask in slot space, lane-index left-pack.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _mask_self_lane(cell_caps: Tuple[int, ...]) -> np.ndarray:
    """[c] the window lane of each center row's own slot: row r of species
    block s (rows ``[off_s, off_s + cs)``) sits at lane ``27 off_s + 13 cs
    + (r - off_s)``."""
    offs = np.cumsum((0,) + cell_caps)[:-1]
    return np.concatenate([
        np.arange(cs) + 27 * int(o) + SELF_STENCIL_INDEX * cs
        for o, cs in zip(offs, cell_caps)]).astype(np.int64)


def _check_mask_inputs(candx, candy, candz, centers, cell_caps):
    cell_caps = tuple(int(x) for x in cell_caps)
    c = sum(cell_caps)
    ncells = candx.shape[0]
    for name, t in (('candx', candx), ('candy', candy), ('candz', candz)):
        if t.dtype != torch.float32 or tuple(t.shape) != (ncells, 27 * c):
            raise ValueError(f'{name} must be float32 [ncells, {27 * c}], got '
                             f'{t.dtype} {tuple(t.shape)}')
    if centers.dtype != torch.float32 or tuple(centers.shape) != (ncells, c, 3):
        raise ValueError(f'centers must be float32 [ncells, {c}, 3], got '
                         f'{centers.dtype} {tuple(centers.shape)}')
    return cell_caps


def window_mask_plain(candx: torch.Tensor, candy: torch.Tensor,
                      candz: torch.Tensor, centers: torch.Tensor, w2: float,
                      cell_caps: Sequence[int]) -> torch.Tensor:
    """Plain version: ``mask [ncells, c, kk]`` bool, true where window lane
    l lies within ``sqrt(w2)`` of center row r and is not r's own slot."""
    cell_caps = _check_mask_inputs(candx, candy, candz, centers, cell_caps)
    dx = candx[:, None, :] - centers[:, :, 0:1]
    dy = candy[:, None, :] - centers[:, :, 1:2]
    dz = candz[:, None, :] - centers[:, :, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    lane = torch.arange(candx.shape[1], device=candx.device)
    self_lane = torch.as_tensor(_mask_self_lane(cell_caps), device=candx.device)
    return (d2 < w2) & (lane[None, :] != self_lane[:, None])[None]


def window_mask_cuda(candx, candy, candz, centers, w2: float,
                     cell_caps: Sequence[int]) -> torch.Tensor:
    """Launch the mask kernel: ``mask [ncells, c, kk]`` bool."""
    cell_caps = _check_mask_inputs(candx, candy, candz, centers, cell_caps)
    if len(cell_caps) > MAX_BLOCKS:
        raise ValueError(f'mask kernel takes at most {MAX_BLOCKS} species')
    _kernels.require_cuda(candx, candy, candz, centers)
    ncells, kk = candx.shape
    mask = torch.empty(ncells, sum(cell_caps), kk, dtype=torch.bool,
                       device=candx.device)
    if ncells:
        _kernels.launch('window_mask', candx.data_ptr(), candy.data_ptr(),
                        candz.data_ptr(), centers.data_ptr(), mask.data_ptr(),
                        ncells, len(cell_caps),
                        (ctypes.c_int * MAX_BLOCKS)(*cell_caps), float(w2),
                        _kernels.stream_handle(candx.device))
    return mask


def window_mask(candx: torch.Tensor, candy: torch.Tensor, candz: torch.Tensor,
                centers: torch.Tensor, w2: float,
                cell_caps: Sequence[int]) -> torch.Tensor:
    """The validity mask: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if candx.device.type == 'cpu':
        return window_mask_plain(candx, candy, candz, centers, w2, cell_caps)
    if candx.device.type != 'cuda':
        raise ValueError(f'no mask kernel for device {candx.device}')
    return window_mask_cuda(candx.contiguous(), candy.contiguous(),
                            candz.contiguous(), centers.contiguous(), w2,
                            cell_caps)


def left_pack_lanes_plain(mask: torch.Tensor, widths: Sequence[int],
                          caps: Sequence[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: per row and block, the block-local lane indices of
    the first ``caps[s]`` valid lanes, -1 beyond the count; the counts."""
    widths, caps = _check_widths(mask, widths, caps, torch.bool, 'mask')
    n = mask.shape[0]
    lanes, counts = [], []
    off = 0
    for w, cap in zip(widths, caps):
        valid = mask[:, off:off + w]
        rank = torch.cumsum(valid.to(torch.int32), 1)            # 1-based
        keep = valid & (rank <= cap)
        col = torch.where(keep, rank - 1, cap).long()
        local = torch.arange(w, dtype=torch.int32, device=mask.device)
        out = torch.full((n, cap + 1), -1, dtype=torch.int32, device=mask.device)
        out.scatter_(1, col, torch.where(keep, local[None, :], -1))
        lanes.append(out[:, :cap])
        counts.append(valid.sum(1, dtype=torch.int32))
        off += w
    return torch.cat(lanes, 1), torch.stack(counts, 1)


def left_pack_lanes_cuda(mask: torch.Tensor, widths: Sequence[int],
                         caps: Sequence[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the lane left-pack: ``(lanes [N, sum(caps)], counts [N,
    npres])``, both int32."""
    widths, caps = _check_widths(mask, widths, caps, torch.bool, 'mask')
    if len(widths) > MAX_BLOCKS:
        raise ValueError(f'lane left-pack takes at most {MAX_BLOCKS} blocks')
    _kernels.require_cuda(mask)
    n = mask.shape[0]
    lanes = torch.empty(n, sum(caps), dtype=torch.int32, device=mask.device)
    counts = torch.empty(n, len(widths), dtype=torch.int32, device=mask.device)
    if n:
        ints = ctypes.c_int * MAX_BLOCKS
        _kernels.launch('left_pack_lanes', mask.data_ptr(), lanes.data_ptr(),
                        counts.data_ptr(), n, mask.shape[1], sum(caps),
                        len(widths), ints(*widths), ints(*caps),
                        _kernels.stream_handle(mask.device))
    return lanes, counts


def left_pack_lanes(mask: torch.Tensor, widths: Sequence[int],
                    caps: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-pack the valid lanes' indices per species block: the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if mask.device.type == 'cpu':
        return left_pack_lanes_plain(mask, widths, caps)
    if mask.device.type != 'cuda':
        raise ValueError(f'no lane left-pack kernel for device {mask.device}')
    return left_pack_lanes_cuda(mask.contiguous(), widths, caps)
