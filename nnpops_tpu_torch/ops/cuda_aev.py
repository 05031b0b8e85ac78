"""The angular AEV kernel (``csrc/angular_aev.cu``), its wrapper, its
autograd Function and its plain PyTorch version.

Port of ``nnpops_tpu/ops/pallas_aev.py`` (``make_angular_kernel``,
``angular_aev_pallas``) with ``pow_impl='split'``, ``fc_impl='poly'`` and
the radial-slice input mode. For each static triple (j, k) of
``triple_tables(layout)`` the term is

    exp(-eta((r_j + r_k)/2 - Rs)^2) * (1 + cos(theta - theta_s))^zeta
        * fc(r_j) * fc(r_k)

summed per species-pair segment into ``[N, n_seg * A]`` columns
(column ``seg*A + rs*n_ts + ts``). :func:`angular_aev` places the segments
into the reference ``[N, P*A]`` layout and applies the 2^(1-zeta) scale.

The Pallas kernel's ``dot_impl``/``red_impl``/``bwd_impl`` selectors, its
bf16x3 selection matmuls and its VMEM block sizing are TPU means, not
semantics. The CUDA kernel takes no triple table: a warp compacts a row's
lanes inside the cutoff per species block and enumerates the same
segments' triples over them (a triple with a lane outside the cutoff adds
an exact 0 in the plain version), so it needs only the species blocks'
caps and first input columns (``_AngularSpec.blk_caps``, ``blk_pos``).

Dispatch: a CPU tensor runs :func:`angular_aev_plain` (gradients by
autograd); a CUDA tensor launches the kernel, forward and backward, or
raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..config import ANIBasis
from ..neighbors.blocked import BlockedLayout
from .aev_blocked import triple_tables, upload

# Degree-8 Chebyshev-node LSQ fit of g(t) = 0.5 cos(pi sqrt(t)) + 0.5 on
# t = (r/rc)^2 in [0, 1] (nnpops_tpu/ops/pallas_window.py FC_COEFFS): exact
# far below f32 resolution, so the cutoff and its derivative run as Horner
# chains. Coefficients low-order first. csrc/angular_aev.cu holds the same.
FC_COEFFS = (0.99999999999953115, -2.4674011001964282, 2.0293560611802657,
             -0.66763136355346187, 0.11766520747089387,
             -0.012903133084020298, 0.00096425294148109802,
             -5.1784521003695567e-05, 1.8597632061664595e-06)

# (n_rs, n_ts) grids the CUDA kernel is instantiated for: ANI-1x/2x (8, 4)
# and the small test basis (3, 3); species blocks it takes (kMaxBlocks).
KERNEL_GRIDS = ((8, 4), (3, 3))
MAX_BLOCKS = 8


def fc_poly_t(t):
    """fc as a function of t = (r/rc)^2, unmasked; t clamped to [0, 1]."""
    p = FC_COEFFS[-1]
    for cf in FC_COEFFS[-2::-1]:
        p = p * t + cf
    return p


def dfc_poly_t(t):
    """d fc / dt at t = (r/rc)^2 (dfc/dr = dfc_poly_t * 2 r / rc^2)."""
    p = FC_COEFFS[-1] * 8.0
    for k in range(7, 0, -1):
        p = p * t + FC_COEFFS[k] * k
    return p


def pow_split(base: torch.Tensor, exponent: float) -> torch.Tensor:
    """``base ** exponent`` with the integer part by binary exponentiation
    and only the fractional part by ``exp(zf * log(base))``: a plain pow of
    zeta = 14.1 amplifies log's error about 14x."""
    zi = int(math.floor(exponent))
    zf = exponent - zi
    result = None
    sq = base
    k = zi
    while k:
        if k & 1:
            result = sq if result is None else result * sq
        k >>= 1
        if k:
            sq = sq * sq
    if zf > 1e-12:
        frac = torch.exp(zf * torch.log(base))
        result = frac if result is None else result * frac
    return result if result is not None else torch.ones_like(base)


def _grids(basis: ANIBasis) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    if basis.angular_rs_grid is None:
        raise NotImplementedError(
            'the angular kernel requires a factored angular grid '
            '(ANIBasis.from_grids with single EtaA/Zeta)')
    return (tuple(float(x) for x in basis.angular_rs_grid),
            tuple(float(x) for x in basis.angular_thetas_grid))


def _lane_positions(layout: BlockedLayout,
                    rad_width: Optional[int]) -> np.ndarray:
    """Input column of each angular lane: the identity for angular planes;
    for radial planes, the leading ``ang_caps[i]`` lanes of each species'
    radial block (angular-first lane order)."""
    if rad_width is None:
        return np.arange(layout.ang_total, dtype=np.int32)
    if rad_width != layout.rad_total:
        raise ValueError(f'rad_width {rad_width} != layout.rad_total '
                         f'{layout.rad_total}')
    return np.concatenate(
        [np.arange(ro, ro + ac, dtype=np.int32)
         for ro, ac in zip(layout.rad_offsets, layout.ang_caps)])


def angular_aev_plain(deltas: torch.Tensor, ang_mask: torch.Tensor,
                      basis: ANIBasis, layout: BlockedLayout,
                      rad_width: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[3, N, W]`` planes and an
    ``[N, Kat]`` angular mask -> unscaled segment sums ``[N, n_seg * A]``.
    Differentiable in ``deltas`` by autograd."""
    rs_grid, ts_grid = _grids(basis)
    tables = triple_tables(layout)
    dev = deltas.device
    ra = float(basis.angular_cutoff)
    eta = float(basis.angular_eta[0])
    zeta = float(basis.angular_zeta[0])
    lanes = torch.as_tensor(_lane_positions(layout, rad_width), device=dev).long()
    d = deltas[:, :, lanes]                                    # [3, N, Kat]
    # Masked lanes move 4*ra away so they fail r < ra by themselves.
    x = torch.where(ang_mask, d[0], d[0] + 4.0 * ra)
    y, z = d[1], d[2]
    r = torch.sqrt(x * x + y * y + z * z)
    valid = r < ra
    r = torch.clamp(r, min=1e-3)
    t = torch.clamp(r * r * (1.0 / (ra * ra)), max=1.0)
    fc = torch.where(valid, fc_poly_t(t), 0.0)

    jj = torch.as_tensor(tables.jj, device=dev).long()
    kk = torch.as_tensor(tables.kk, device=dev).long()
    x1, y1, z1, r1, fc1 = (a[:, jj] for a in (x, y, z, r, fc))
    x2, y2, z2, r2, fc2 = (a[:, kk] for a in (x, y, z, r, fc))
    dot12 = x1 * x2 + y1 * y2 + z1 * z2
    inv12 = 1.0 / (r1 * r2)
    if basis.torchani:
        cos_t = torch.clamp(0.95 * dot12 * inv12, -0.95, 0.95)
        sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    else:
        cos_t = torch.clamp(dot12 * inv12, -1.0, 1.0)
        cx = y1 * z2 - z1 * y2
        cy = z1 * x2 - x1 * z2
        cz = x1 * y2 - y1 * x2
        sin_t = torch.sqrt(torch.clamp(cx * cx + cy * cy + cz * cz,
                                       min=1e-12)) * inv12
    rm = 0.5 * (r1 + r2)
    vf = fc1 * fc2                                  # zero unless both valid
    cps = torch.stack(
        [pow_split(torch.clamp(1.0 + (cos_t * math.cos(ts)
                                      + sin_t * math.sin(ts)), min=1e-20),
                   zeta) for ts in ts_grid], -1)    # [N, T, n_ts]
    es = torch.stack([vf * torch.exp(-eta * (rm - rs) ** 2)
                      for rs in rs_grid], -1)        # [N, T, n_rs]
    terms = (es[..., :, None] * cps[..., None, :]).flatten(2)   # [N, T, A]
    b = tables.seg_bounds
    return torch.cat([terms[:, b[s]:b[s + 1]].sum(1)
                      for s in range(len(b) - 1)], 1)


class _AngularSpec:
    """Device tables and host constants of one (basis, layout, width)."""

    def __init__(self, basis: ANIBasis, layout: BlockedLayout,
                 rad_width: Optional[int], device: torch.device):
        rs_grid, ts_grid = _grids(basis)
        if (len(rs_grid), len(ts_grid)) not in KERNEL_GRIDS:
            raise NotImplementedError(
                f'angular kernel built for (n_rs, n_ts) in {KERNEL_GRIDS}, '
                f'got {(len(rs_grid), len(ts_grid))}')
        if not 1 <= len(layout.ang_caps) <= MAX_BLOCKS:
            raise NotImplementedError(
                f'angular kernel built for 1..{MAX_BLOCKS} species blocks, '
                f'got {len(layout.ang_caps)}')
        if float(basis.angular_zeta[0]) < 1.0:
            raise NotImplementedError('angular kernel needs zeta >= 1')
        lanes = _lane_positions(layout, rad_width)
        self.width = layout.ang_total if rad_width is None else rad_width
        col_lane = np.full(self.width, -1, np.int32)
        col_lane[lanes] = np.arange(len(lanes), dtype=np.int32)
        self.col_lane = upload(col_lane, torch.int32, device)
        self.kat = layout.ang_total
        self.n_blk = len(layout.ang_caps)
        ints = ctypes.c_int * MAX_BLOCKS
        self.blk_caps = ints(*layout.ang_caps)
        # Input column of each species block's first angular lane.
        self.blk_pos = ints(*(layout.ang_offsets if rad_width is None
                              else layout.rad_offsets))
        self.n_seg = self.n_blk * (self.n_blk + 1) // 2
        self.n_rs, self.n_ts = len(rs_grid), len(ts_grid)
        self.out_w = self.n_seg * self.n_rs * self.n_ts
        floats = ctypes.c_float * 16
        self.rs = floats(*rs_grid)
        self.cts = floats(*(math.cos(ts) for ts in ts_grid))
        self.sts = floats(*(math.sin(ts) for ts in ts_grid))
        self.ra = float(basis.angular_cutoff)
        self.eta = float(basis.angular_eta[0])
        self.zeta = float(basis.angular_zeta[0])
        self.torchani = int(bool(basis.torchani))

    def scalars(self, n_rows: int, stream: int):
        head = (n_rows, self.width, self.kat, self.n_blk,
                ctypes.addressof(self.blk_caps),
                ctypes.addressof(self.blk_pos), self.n_rs, self.n_ts,
                ctypes.addressof(self.rs),
                ctypes.addressof(self.cts), ctypes.addressof(self.sts))
        return head + (self.ra, self.eta, self.zeta, self.torchani, stream)


@functools.lru_cache(maxsize=32)
def _spec(basis: ANIBasis, layout: BlockedLayout, rad_width: Optional[int],
          device: torch.device) -> _AngularSpec:
    return _AngularSpec(basis, layout, rad_width, device)


def _check_inputs(spec: _AngularSpec, deltas: torch.Tensor,
                  ang_mask: torch.Tensor) -> None:
    n = deltas.shape[1]
    if deltas.dtype != torch.float32 or deltas.shape != (3, n, spec.width):
        raise ValueError(f'deltas must be float32 [3, N, {spec.width}], got '
                         f'{deltas.dtype} {tuple(deltas.shape)}')
    if ang_mask.dtype != torch.bool or ang_mask.shape != (n, spec.kat):
        raise ValueError(f'ang_mask must be bool [N, {spec.kat}], got '
                         f'{ang_mask.dtype} {tuple(ang_mask.shape)}')
    _kernels.require_cuda(deltas, ang_mask)


def angular_fwd_cuda(deltas: torch.Tensor, ang_mask: torch.Tensor,
                     spec: _AngularSpec) -> torch.Tensor:
    """Launch the forward kernel: ``[N, n_seg * A]`` segment sums."""
    _check_inputs(spec, deltas, ang_mask)
    n = deltas.shape[1]
    out = torch.empty(n, spec.out_w, dtype=torch.float32, device=deltas.device)
    if n:
        _kernels.launch(
            'angular_aev_fwd', deltas.data_ptr(), ang_mask.data_ptr(),
            out.data_ptr(),
            *spec.scalars(n, _kernels.stream_handle(deltas.device)))
    return out


def angular_bwd_cuda(deltas: torch.Tensor, ang_mask: torch.Tensor,
                     g: torch.Tensor, spec: _AngularSpec) -> torch.Tensor:
    """Launch the backward kernel: delta cotangents ``[3, N, W]`` (zeros on
    the non-angular lanes of radial planes)."""
    _check_inputs(spec, deltas, ang_mask)
    n = deltas.shape[1]
    if g.dtype != torch.float32 or g.shape != (n, spec.out_w):
        raise ValueError(f'cotangent must be float32 [N, {spec.out_w}]')
    _kernels.require_cuda(g)
    out = torch.empty_like(deltas)
    if n:
        _kernels.launch(
            'angular_aev_bwd', deltas.data_ptr(), ang_mask.data_ptr(),
            spec.col_lane.data_ptr(), g.data_ptr(), out.data_ptr(),
            *spec.scalars(n, _kernels.stream_handle(deltas.device)))
    return out


class AngularAEVFunction(torch.autograd.Function):
    """Kernel forward; recompute-based kernel backward (nothing is saved but
    the inputs, as in the Pallas VJP)."""

    @staticmethod
    def forward(ctx, deltas, ang_mask, spec):
        ctx.save_for_backward(deltas, ang_mask)
        ctx.spec = spec
        return angular_fwd_cuda(deltas, ang_mask, spec)

    @staticmethod
    def backward(ctx, g):
        deltas, ang_mask = ctx.saved_tensors
        return (angular_bwd_cuda(deltas, ang_mask, g.contiguous(), ctx.spec),
                None, None)


def angular_aev_segments(deltas: torch.Tensor, ang_mask: torch.Tensor,
                         basis: ANIBasis, layout: BlockedLayout,
                         rad_width: Optional[int] = None) -> torch.Tensor:
    """Unscaled angular segment sums ``[N, n_seg * A]``: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if deltas.device.type == 'cpu':
        return angular_aev_plain(deltas, ang_mask, basis, layout, rad_width)
    if deltas.device.type != 'cuda':
        raise ValueError(f'no angular kernel for device {deltas.device}')
    spec = _spec(basis, layout, rad_width, deltas.device)
    return AngularAEVFunction.apply(deltas.contiguous(),
                                    ang_mask.contiguous(), spec)


def place_angular(raw: torch.Tensor, basis: ANIBasis,
                  layout: BlockedLayout) -> torch.Tensor:
    """Segments -> the reference angular layout ``[N, P*A]``, scaled by
    2^(1-zeta); species pairs absent from the system stay exact zeros."""
    n = raw.shape[0]
    tables = triple_tables(layout)
    rs_grid, ts_grid = _grids(basis)
    a_len = len(rs_grid) * len(ts_grid)
    num_pairs = basis.num_species_pairs
    cols = [raw.new_zeros(n, a_len)] * num_pairs
    for i_seg, pid in enumerate(tables.pair_ids):
        cols[pid] = cols[pid] + raw[:, i_seg * a_len:(i_seg + 1) * a_len]
    angular = torch.stack(cols, 1)                    # [N, P, A]
    scale = 2.0 ** (1.0 - float(basis.angular_zeta[0]))
    return (angular * scale).reshape(n, num_pairs * a_len)


def angular_aev(deltas: torch.Tensor, ang_mask: torch.Tensor,
                basis: ANIBasis, layout: BlockedLayout,
                rad_width: Optional[int] = None) -> torch.Tensor:
    """Full angular AEV ``[N, P*A]`` through the kernel wrapper (the
    counterpart of ``angular_aev_pallas``). With ``rad_width`` set,
    ``deltas`` are the radial planes ``[3, N, rad_width]``."""
    return place_angular(
        angular_aev_segments(deltas, ang_mask, basis, layout, rad_width),
        basis, layout)
