"""The left-pack kernel (``csrc/left_pack.cu``), its wrapper and its plain
PyTorch version.

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

Dispatch: a CPU tensor runs :func:`left_pack_plain`; a CUDA tensor
launches the kernel or raises. There is no gradient (the selection is
frozen).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import _kernels

MAX_BLOCKS = 8      # species blocks the kernel takes (csrc/left_pack.cu)


def _check_widths(keys: torch.Tensor, widths, caps) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    widths = tuple(int(w) for w in widths)
    caps = tuple(int(k) for k in caps)
    if len(widths) != len(caps):
        raise ValueError('widths and caps must align')
    if keys.dim() != 2 or keys.shape[1] != sum(widths):
        raise ValueError(f'keys must be [N, {sum(widths)}], got {tuple(keys.shape)}')
    if keys.dtype != torch.int32:
        raise ValueError(f'keys must be int32, got {keys.dtype}')
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
