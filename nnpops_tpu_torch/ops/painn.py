"""PaiNN's equivariant message (Schütt, Unke and Gastegger, ICML 2021,
eqs. 7-8; SchNetPack's ``PaiNNInteraction``) over the cell list's deltas
payload, as one autograd Function with a hand-written, scatter-free
backward.

For every lane (i, l) of the symmetric full neighbor list, with j =
``indices[i, l]``, d its length and u its unit vector (i -> j):

    rbf_n(d) = sin(n pi d / rc) / d,   n = 1 .. R
    W_ij = (rbf(d) Wf + bf) fc(d)      [3F], exactly zero where d >= rc
    x = phi_j * W_ij = (x_s, x_vv, x_vs)
    m_s[i] = sum_l x_s
    m_v[i] = sum_l (v_j * x_vv + u (x) x_vs)           [3, F]

``phi`` [N, 3F] is the per-atom context phi(s), ``v`` [N, 3, F] the vector
state; both come from and go back to autograd outside. ``fc`` is the cosine
cutoff.

* **Forward**: in row chunks of ``chunk_rows(K, F)`` rows, so that each
  [rows, K, 3F] lane temporary stays at or under ``CHUNK_BYTES`` (1 GiB).
* **Saved**: the per-atom ``phi`` and ``v`` and the payload (d, u, the
  indices and the live-lane mask); the lane tensors are computed again in
  the backward.
* **Backward**: each row on its own. Its lanes give the cotangents of
  their d and u (which ``neighbors.cell_list.lane_geometry`` and
  ``CellList.payload_deltas_from_selection`` take to the positions), and
  its own atom's d phi and d v come as gathers of the cotangents g_s, g_v
  of the atoms in its row: the list is symmetric, W_ji = W_ij and u_ji =
  -u_ij, so an entry's j half is its mirrored entry's. No ``index_add``, no
  scatter, no atomics. On a CUDA tensor one launch of the fused kernel
  ``csrc/painn_bwd.cu`` over all rows (:func:`painn_bwd_cuda`, true
  float32, ``_kernels.LAUNCHES['painn_bwd']``); elsewhere the plain
  :func:`_rows_backward` in the forward's chunks.
* **Lanes**: padded lanes and the lanes of a Verlet skin (d >= rc) give
  exactly zero, forward and backward.
* **Precision**: the dtype of the inputs (float32 on the MD path, with
  TF32 off as the package sets it); the forward is the same plain PyTorch
  on the CPU and the card, the card's backward kernel takes float32 only.
* **Weights**: no weight gradient is computed. The MD path needs none; a
  filter weight that requires one raises, rather than being dropped.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _kernels
from ..config import PaiNNConfig
from ..utils.profiling import COUNTERS
from .aev_blocked import device_constant
from .cuda_cfconv import _pad_row, _row_chunks

Tensor = torch.Tensor

# Bytes a [rows, K, 3F] lane temporary of the message may take.
CHUNK_BYTES = 1 << 30
# The widths and the radial count ``csrc/painn_bwd.cu`` is built for.
KERNEL_WIDTHS = (32, 64, 96, 128)
KERNEL_RADIAL = 20


def chunk_rows(k: int, width: int, itemsize: int = 4) -> int:
    """Atom rows a chunk of the message takes: the most whose [rows, K,
    3F] lane temporaries stay at or under ``CHUNK_BYTES`` (at least one).
    5,461 at K 128, F 128 in float32."""
    return max(1, CHUNK_BYTES // (k * 3 * width * itemsize))


def _freq(r: int, rc: float, dtype, device) -> Tensor:
    """The rbf frequencies n pi / rc, n = 1 .. r."""
    return device_constant(tuple(n * math.pi / rc for n in range(1, r + 1)),
                           dtype, device)


def _filters(d: Tensor, live: Tensor, wf: Tensor, bf: Tensor, rc: float):
    """W [R, K, 3F] of the lanes, and what its adjoint needs: the safe
    lengths, the rbf arguments and values, W before the cutoff, and the
    cutoff (zero on dead lanes)."""
    freq = _freq(wf.shape[0], rc, d.dtype, d.device)
    ds = torch.where(live, d, 1.0)
    arg = ds[..., None] * freq
    rbf = torch.sin(arg) / ds[..., None]
    pre = rbf @ wf + bf
    fc = torch.where(live, 0.5 * torch.cos(ds * (math.pi / rc)) + 0.5, 0.0)
    return pre * fc[..., None], (freq, ds, arg, rbf, pre, fc)


def _gather(table: Tensor, idx: Tensor, *shape) -> Tensor:
    r, k = idx.shape
    return table.index_select(0, idx.reshape(-1)).view(r, k, *shape)


def _rows_forward(phi_pad: Tensor, v_pad: Tensor, d: Tensor, u: Tensor,
                  idx: Tensor, live: Tensor, wf: Tensor, bf: Tensor,
                  rc: float) -> Tuple[Tensor, Tensor]:
    """(m_s [R, F], m_v [R, 3, F]) of a block of rows, in plain
    differentiable PyTorch; ``phi_pad`` [N+1, 3F] and ``v_pad`` [N+1, 3F]
    end in a zero row, which the padded lanes (index N) read."""
    f = v_pad.shape[1] // 3
    w, _ = _filters(d, live, wf, bf, rc)
    x = _gather(phi_pad, idx, 3 * f) * w
    xs, xvv, xvs = x.split(f, -1)
    vj = _gather(v_pad, idx, 3, f)
    mv = (vj * xvv[:, :, None, :]).sum(1) + torch.bmm(u.transpose(1, 2), xvs)
    return xs.sum(1), mv


def _rows_backward(rows: slice, phi_pad, v_pad, gs_pad, gv_pad, d, u, idx,
                   live, wf, bf, rc):
    """(dd [R, K], du [R, K, 3], dphi [R, 3F], dv [R, 3, F]) of the rows
    ``rows``: their lanes' d and u cotangents, and their own atoms' phi and
    v cotangents from the mirrored entries, read through their own lanes
    (W_ji = W_ij, u_ji = -u_ij)."""
    r, k = d.shape
    f = v_pad.shape[1] // 3
    w, (freq, ds, arg, rbf, pre, fc) = _filters(d, live, wf, bf, rc)
    phj = _gather(phi_pad, idx, 3 * f)
    vj = _gather(v_pad, idx, 3, f)
    gs_i = gs_pad[rows]
    gv_i = gv_pad[rows].view(r, 3, f)
    # The lanes as (i, l): x = phj * W.
    dxvv = (gv_i[:, None] * vj).sum(2)
    dxvs = torch.bmm(u, gv_i)
    dw = phj * torch.cat([gs_i[:, None, :].expand(r, k, f), dxvv, dxvs], -1)
    du = torch.bmm(phj[..., 2 * f:] * w[..., 2 * f:], gv_i.transpose(1, 2))
    drbf = (dw * fc[..., None]) @ wf.t()
    dd = (torch.sum(drbf * (freq * torch.cos(arg) - rbf), -1) / ds
          - torch.sum(dw * pre, -1) * (0.5 * math.pi / rc)
          * torch.sin(ds * (math.pi / rc)))
    dd = torch.where(live, dd, 0.0)
    # The row's atom as the j of its lanes' mirrored entries.
    gsj = _gather(gs_pad, idx, f)
    gvj = _gather(gv_pad, idx, 3, f)
    ws, wvv, wvs = w.split(f, -1)
    a = (wvv[:, :, None, :] * gvj).sum(1)                       # [R, 3, F]
    v_row = v_pad[rows].view(r, 3, f)
    dphi = torch.cat([(ws * gsj).sum(1), (v_row * a).sum(1),
                      -(wvs * (gvj * u[..., None]).sum(2)).sum(1)], -1)
    dv = phi_pad[rows, f:2 * f][:, None, :] * a
    return dd, du, dphi, dv


def painn_bwd_plain(phi_pad: Tensor, v_pad: Tensor, d: Tensor, u: Tensor,
                    idx: Tensor, live: Tensor, wf: Tensor, bf: Tensor,
                    gs: Tensor, gv: Tensor, rc: float,
                    rows_per_chunk: Optional[int]):
    """(dd, du, dphi, dv) of :func:`painn_bwd_cuda`'s arguments by
    :func:`_rows_backward` in chunks of ``rows_per_chunk`` rows: the
    backward on a CPU tensor, and the kernel's plain version."""
    n, f = gs.shape
    gs_pad = _pad_row(gs)
    gv_pad = _pad_row(gv.reshape(n, 3 * f))
    dd, du = torch.empty_like(d), torch.empty_like(u)
    dphi = phi_pad.new_empty(n, 3 * f)
    dv = phi_pad.new_empty(n, 3, f)
    for s in _row_chunks(n, rows_per_chunk):
        dd[s], du[s], dphi[s], dv[s] = _rows_backward(
            s, phi_pad, v_pad, gs_pad, gv_pad, d[s], u[s], idx[s], live[s],
            wf, bf, rc)
    return dd, du, dphi, dv


def painn_bwd_cuda(phi_pad: Tensor, v_pad: Tensor, d: Tensor, u: Tensor,
                   idx: Tensor, live: Tensor, wf: Tensor, bf: Tensor,
                   gs: Tensor, gv: Tensor, rc: float):
    """One launch of the fused backward kernel over all rows: (dd [N, K],
    du [N, K, 3], dphi [N, 3F], dv [N, 3, F]), what :func:`painn_bwd_plain`
    gives. ``phi_pad``, ``v_pad`` [N+1, 3F] end in a zero row,
    ``idx`` is int64, ``live`` bool, ``gs`` [N, F], ``gv`` [N, 3, F]; every
    tensor float32 and contiguous on the current CUDA device."""
    n, k = d.shape
    f, r = gs.shape[1], wf.shape[0]
    if f not in KERNEL_WIDTHS or r != KERNEL_RADIAL:
        raise ValueError(f'the PaiNN backward kernel takes width in '
                         f'{KERNEL_WIDTHS} and {KERNEL_RADIAL} radial '
                         f'functions, got width {f}, {r} radial functions')
    f32 = torch.float32
    shapes = ((phi_pad, (n + 1, 3 * f), f32), (v_pad, (n + 1, 3 * f), f32),
              (d, (n, k), f32), (u, (n, k, 3), f32),
              (idx, (n, k), torch.int64), (live, (n, k), torch.bool),
              (wf, (r, 3 * f), f32), (bf, (3 * f,), f32), (gs, (n, f), f32),
              (gv, (n, 3, f), f32))
    for t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f'expected {dtype} {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
    _kernels.require_cuda(*(t for t, _, _ in shapes))
    freq = _freq(r, rc, f32, d.device)
    dd, du = torch.empty_like(d), torch.empty_like(u)
    dphi, dv = phi_pad.new_empty(n, 3 * f), phi_pad.new_empty(n, 3, f)
    _kernels.launch(
        'painn_bwd', *(t.data_ptr() for t in (
            phi_pad, v_pad, d, u, idx, live, wf, bf, freq, gs, gv, dd, du,
            dphi, dv)),
        n, k, f, r, 0.5 * math.pi / rc, _kernels.stream_handle(d.device))
    return dd, du, dphi, dv


class PaiNNMessage(torch.autograd.Function):
    """(m_s, m_v) of one message over the deltas payload; see the module
    docstring."""

    @staticmethod
    def forward(ctx, phi, v, d, u, idx, mask, wf, bf, rc, rows_per_chunk):
        if ctx.needs_input_grad[6] or ctx.needs_input_grad[7]:
            raise RuntimeError(
                'painn_message computes no weight gradients (the MD path '
                'needs none); its filter weights must not require grad')
        n, f = v.shape[0], v.shape[2]
        live = mask & (d < rc)
        idx = idx.long()
        phi_pad = _pad_row(phi)
        v_pad = _pad_row(v.reshape(n, 3 * f))
        ms = phi.new_empty(n, f)
        mv = phi.new_empty(n, 3, f)
        for s in _row_chunks(n, rows_per_chunk):
            ms[s], mv[s] = _rows_forward(phi_pad, v_pad, d[s], u[s], idx[s],
                                         live[s], wf, bf, rc)
        ctx.save_for_backward(phi_pad, v_pad, d, u, idx, live, wf, bf)
        ctx.rc, ctx.rows_per_chunk = rc, rows_per_chunk
        return ms, mv

    @staticmethod
    def backward(ctx, gs, gv):
        phi_pad, v_pad, d, u, idx, live, wf, bf = ctx.saved_tensors
        if d.device.type == 'cuda':
            dd, du, dphi, dv = painn_bwd_cuda(
                phi_pad, v_pad, d.contiguous(), u.contiguous(), idx, live,
                wf.contiguous(), bf.contiguous(), gs.contiguous(),
                gv.contiguous(), ctx.rc)
        else:
            dd, du, dphi, dv = painn_bwd_plain(
                phi_pad, v_pad, d, u, idx, live, wf, bf, gs, gv, ctx.rc,
                ctx.rows_per_chunk)
        return dphi, dv, dd, du, None, None, None, None, None, None


def painn_message(phi: Tensor, v: Tensor, d: Tensor, u: Tensor,
                  indices: Tensor, mask: Tensor, filter_w: Tensor,
                  filter_b: Tensor, config: PaiNNConfig,
                  rows_per_chunk: Optional[int] = None,
                  plain: bool = False) -> Tuple[Tensor, Tensor]:
    """One PaiNN message: (m_s [N, F], m_v [N, 3, F]) from the per-atom
    ``phi`` [N, 3F] and ``v`` [N, 3, F] over the lanes (``d``, ``u``,
    ``indices`` padded with N, ``mask``) of a symmetric full neighbor list
    (``CellList.payload_deltas_from_selection``, then
    ``cell_list.lane_geometry``), with the filter ``filter_w`` [R, 3F],
    ``filter_b`` [3F].
    ``rows_per_chunk`` defaults to ``chunk_rows``. ``plain``: autograd
    through the same forward, unchunked (the adjoint tests' oracle). The
    lanes go into ``COUNTERS['painn_lanes']``."""
    COUNTERS['painn_lanes'] += d.numel()
    rc = float(config.cutoff)
    if plain:
        n, f = v.shape[0], v.shape[2]
        return _rows_forward(_pad_row(phi), _pad_row(v.reshape(n, 3 * f)),
                             d, u, indices.long(), mask & (d < rc), filter_w,
                             filter_b, rc)
    if rows_per_chunk is None:
        rows_per_chunk = chunk_rows(d.shape[1], config.width,
                                    phi.element_size())
    return PaiNNMessage.apply(phi, v, d, u, indices, mask, filter_w,
                              filter_b, rc, rows_per_chunk)
