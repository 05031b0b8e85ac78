"""The symmetric z-pair radial AEV (``window_radial='pair'``): the kernel
(``csrc/pair_radial.cu``), forward and backward, its wrapper, its autograd
Function, its plain PyTorch version and the host side around it.

Port of ``nnpops_tpu/ops/pallas_zpair.py`` (``_make_pair_kernels`` and
``pair_radial_aev``). The directed window radial (``ops.cuda_window``)
visits every atom pair twice; here each unordered pair of cell columns is
visited once:

* lanes are z-triples: per cell, the species-major concatenation of the
  slots of its z-1 / z / z+1 cells (``L = 3c`` lanes; :func:`_build_z3`,
  periodic z images shifted into place);
* a cell's center rows meet the z-triples of its own column and of the
  four half xy-offsets ``HALF_OFFSETS[1:]``, whose periodic image shifts
  are per-(cell, offset) vectors (:func:`_xy_shift_factors`);
* the kernel writes the center-side rows ``out_a [ncells, c, P*R]`` and,
  for the four half offsets, the neighbour-side rows transposed,
  ``out_b [ncells, 4, P*R, L]``, which :func:`_fold_b` folds onto the
  neighbours' home cells with static 3-axis ``torch.roll``s (the adjoint of
  a roll is a roll, so the fold needs no scatter).

A pair is valid when ``d2 < rc^2``, except a center's own lane in its own
column; ``fc`` is the cosine cutoff (not the degree-8 polynomial of the
window kernel). One contract the port adds, as ``ops.cuda_window`` does: a
center at or beyond ``EMPTY_ROW`` is an empty slot and evaluates no pair.
The Pallas kernel pairs empty centers with the empty lanes of their own
column and writes rows of empty slots that no caller reads; every other
row and every cotangent agree.

Dispatch: a CPU tensor runs :func:`pair_radial_plain` (gradients by
autograd); a CUDA tensor launches the forward kernel, and the backward
kernel under autograd, or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .cuda_window import EMPTY_ROW, _radial_params

# xy-plane half offsets: the self column (0, 0) and 4 of the 8 neighbour
# columns; the other 4 are covered by the neighbour side of their reverse.
HALF_OFFSETS = ((0, 0), (1, 0), (0, 1), (1, 1), (1, -1))
MAX_SPECIES = 8     # csrc/pair_radial.cu limits
MAX_RADIAL = 16
MAX_RUNS = 40


@functools.lru_cache(maxsize=16)
def _xy_shift_factors(ncells3: Tuple[int, int, int]) -> np.ndarray:
    """[ncells, 4, 2] periodic wrap factors (fx, fy) of cell a's four
    half-offset neighbour columns."""
    nx, ny, nz = ncells3
    ax = np.arange(nx)[:, None, None]
    ay = np.arange(ny)[None, :, None]
    out = np.zeros((nx, ny, nz, 4, 2), np.int8)
    for d, (ox, oy) in enumerate(HALF_OFFSETS[1:]):
        out[..., d, 0] = np.broadcast_to(np.floor_divide(ax + ox, nx),
                                         (nx, ny, nz))
        out[..., d, 1] = np.broadcast_to(np.floor_divide(ay + oy, ny),
                                         (nx, ny, nz))
    return out.reshape(nx * ny * nz, 4, 2)


@functools.lru_cache(maxsize=16)
def _column_cells(ncells3: Tuple[int, int, int]) -> np.ndarray:
    """[5, ncells] the cell whose z-triple is column d of cell a (the Pallas
    kernel's z3 index maps)."""
    nx, ny, nz = ncells3
    a = np.arange(nx * ny * nz)
    az, axy = a % nz, a // nz
    ay, ax = axy % ny, axy // ny
    return np.stack([(((ax + ox) % nx) * ny + (ay + oy) % ny) * nz + az
                     for ox, oy in HALF_OFFSETS])


def _build_z3(slots: torch.Tensor, box: torch.Tensor, ncells3,
              cell_caps) -> torch.Tensor:
    """[ncells, 3, L] z-triple coordinate planes: per species s, lanes
    [z-1 | z | z+1] of that species' slots, periodic z images shifted into
    place, built with rolls in plane layout."""
    nx, ny, nz = ncells3
    cell_caps = tuple(int(x) for x in cell_caps)
    c = sum(cell_caps)
    offs = np.cumsum((0,) + cell_caps)[:-1]
    p4 = slots.t().reshape(3, nx * ny, nz, c)
    iz = torch.arange(nz, device=slots.device)[None, None, :, None]
    boxz = box[2].reshape(3, 1, 1, 1)
    zm = torch.roll(p4, 1, dims=2)
    zm = torch.where(iz == 0, zm - boxz, zm)
    zp = torch.roll(p4, -1, dims=2)
    zp = torch.where(iz == nz - 1, zp + boxz, zp)
    parts = []
    for s, cs in enumerate(cell_caps):
        sl = slice(int(offs[s]), int(offs[s]) + cs)
        parts.extend([zm[..., sl], p4[..., sl], zp[..., sl]])
    z3 = torch.cat(parts, 3)                              # [3, nxy, nz, L]
    return z3.reshape(3, nx * ny * nz, 3 * c).permute(1, 0, 2).contiguous()


def _fold_b(out_b: torch.Tensor, ncells3, cell_caps, out_w: int) -> torch.Tensor:
    """Fold the neighbour-side rows onto their home cells: out_b[a, d, :, l]
    (lane l = species s, z offset dz, rank rk of column a_xy + off_d) belongs
    to cell (a_xy + off_d, a_z + dz), slot (s, rk). Static 3-axis rolls."""
    nx, ny, nz = ncells3
    cell_caps = tuple(int(x) for x in cell_caps)
    offs = np.cumsum((0,) + cell_caps)[:-1]
    ob = out_b.reshape(nx, ny, nz, 4, out_w, 3 * sum(cell_caps))
    pieces = [None] * len(cell_caps)
    for d, (ox, oy) in enumerate(HALF_OFFSETS[1:]):
        for s, cs in enumerate(cell_caps):
            base = 3 * int(offs[s])
            for dzi, dz in enumerate((-1, 0, 1)):
                sl = ob[:, :, :, d, :, base + dzi * cs:base + (dzi + 1) * cs]
                sl = torch.roll(sl.reshape(nx, ny, nz, out_w * cs),
                                (ox, oy, dz), dims=(0, 1, 2))
                pieces[s] = sl if pieces[s] is None else pieces[s] + sl
    cells = [p.reshape(nx * ny * nz, out_w, cs).transpose(1, 2)
             for p, cs in zip(pieces, cell_caps)]
    return torch.cat(cells, 1)                            # [ncells, c, out_w]


class PairGeometry:
    """Static row and lane geometry of one (grid, cell_caps): the species
    row blocks, the z-triple lane blocks and the self lanes of the own
    column."""

    def __init__(self, ncells3: Tuple[int, int, int],
                 cell_caps: Tuple[int, ...]):
        self.ncells3 = tuple(int(x) for x in ncells3)
        self.cell_caps = tuple(int(x) for x in cell_caps)
        self.ncells = int(np.prod(self.ncells3))
        self.npres = len(self.cell_caps)
        self.c = sum(self.cell_caps)
        self.ll = 3 * self.c
        offs = np.cumsum((0,) + self.cell_caps)
        self.row_off = tuple(int(x) for x in offs)
        self.lane_bounds = tuple((3 * int(offs[s]), 3 * int(offs[s + 1]))
                                 for s in range(self.npres))
        self.self_lane = np.concatenate([
            np.arange(offs[s], offs[s + 1]) + 2 * offs[s] + cs
            for s, cs in enumerate(self.cell_caps)]).astype(np.int64)


def pair_runs(geo: PairGeometry) -> Tuple[np.ndarray, ...]:
    """The kernel's run table: (first lane, lanes, species) of each z-run,
    one species' slots of one z-cell of a z-triple (``cell_caps[s]`` lanes
    from ``lane_bounds[s][0] + dz * cell_caps[s]``, dz = 0, 1, 2 for z-1,
    z, z+1), cut into pieces of at most 32 lanes. The runs tile ``[0, L)``
    in order, species-major; the kernel walks each in each of the five
    columns."""
    first, length, species = [], [], []
    for s, ((lo, _), cs) in enumerate(zip(geo.lane_bounds, geo.cell_caps)):
        for dz in range(3):
            for b in range(0, cs, 32):
                first.append(lo + dz * cs + b)
                length.append(min(32, cs - b))
                species.append(s)
    return (np.asarray(first, np.int64), np.asarray(length, np.int64),
            np.asarray(species, np.int64))


@functools.lru_cache(maxsize=32)
def _geometry(ncells3, cell_caps) -> PairGeometry:
    return PairGeometry(ncells3, cell_caps)


def pair_radial_plain(ctr: torch.Tensor, z3: torch.Tensor, shift: torch.Tensor,
                      radial_cutoff: float, radial_eta: Sequence[float],
                      radial_rs: Sequence[float], ncells3, cell_caps,
                      torchani: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(out_a [ncells, c, P*R], out_b
    [ncells, 4, P*R, L])`` from ``ctr [ncells, c, 3]``, ``z3 [ncells, 3,
    L]`` and ``shift [ncells, 4, 3]``; differentiable by autograd."""
    geo = _geometry(tuple(int(x) for x in ncells3),
                    tuple(int(x) for x in cell_caps))
    etas, rs = _radial_params(radial_eta, radial_rs)
    rc = float(radial_cutoff)
    scale = 0.25 if torchani else 1.0
    dev = ctr.device
    cols = torch.as_tensor(_column_cells(geo.ncells3), device=dev)
    lanes = z3.index_select(0, cols.reshape(-1)).reshape(
        5, geo.ncells, 3, geo.ll).permute(1, 0, 2, 3)     # [ncells, 5, 3, L]
    sh5 = torch.cat([shift.new_zeros(geo.ncells, 1, 3), shift], 1)
    lanes = lanes + sh5[..., None]
    d = [lanes[:, None, :, k, :] - ctr[:, :, None, k:k + 1]
         for k in range(3)]                               # [ncells, c, 5, L]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    lane = torch.arange(geo.ll, device=dev)
    own = torch.zeros(5, dtype=torch.bool, device=dev)
    own[0] = True
    is_self = (lane[None, :] == torch.as_tensor(geo.self_lane, device=dev)[:, None])
    valid = ((d2 < rc * rc) & ~(own[None, :, None] & is_self[:, None, :])[None]
             & (ctr[:, :, 0] < EMPTY_ROW)[:, :, None, None])
    r = torch.sqrt(torch.clamp(d2, min=1e-12))
    fc = torch.where(valid, 0.5 * torch.cos((math.pi / rc) * r) + 0.5, 0.0)
    rm = torch.clamp(r, max=rc)
    n_r = len(rs)
    out_a = [None] * (geo.npres * n_r)
    out_b = [None] * (geo.npres * n_r)
    for q, (eta, r0) in enumerate(zip(etas, rs)):
        we = fc * torch.exp(-eta * (rm - r0) ** 2)
        we_lanes = we.sum(2)                              # [ncells, c, L]
        for s in range(geo.npres):
            lo, hi = geo.lane_bounds[s]
            out_a[s * n_r + q] = scale * we_lanes[:, :, lo:hi].sum(2)
            r0_, r1_ = geo.row_off[s], geo.row_off[s + 1]
            out_b[s * n_r + q] = scale * we[:, r0_:r1_, 1:].sum(1)
    return torch.stack(out_a, 2), torch.stack(out_b, 2)


class _PairSpec:
    """Host constants of one kernel configuration, as ctypes arrays (the
    geometry is :class:`PairGeometry`'s, which the plain version uses)."""

    def __init__(self, geo: PairGeometry, radial_cutoff, radial_eta,
                 radial_rs, torchani):
        etas, rs = _radial_params(radial_eta, radial_rs)
        first, length, species = pair_runs(geo)
        if (geo.npres > MAX_SPECIES or len(rs) > MAX_RADIAL
                or len(first) > MAX_RUNS):
            raise NotImplementedError(
                f'pair radial kernel takes <= {MAX_SPECIES} species, <= '
                f'{MAX_RADIAL} radial functions and <= {MAX_RUNS} z-runs')
        if min(geo.ncells3) < 3:
            raise ValueError('the pair radial kernel needs >= 3 cells per axis')
        self.geo = geo
        self.n_r = len(rs)
        self.out_w = geo.npres * self.n_r
        run_ints = ctypes.c_int * len(first)
        self.row_off = (ctypes.c_int * (MAX_SPECIES + 1))(*geo.row_off)
        self.run_first = run_ints(*first.tolist())
        self.run_len = run_ints(*length.tolist())
        self.run_sp = run_ints(*species.tolist())
        floats = ctypes.c_float * MAX_RADIAL
        self.eta = floats(*etas)
        self.rs = floats(*rs)
        self.rc = float(radial_cutoff)
        self.scale = 0.25 if torchani else 1.0

    def scalars(self, stream: int):
        nx, ny, nz = self.geo.ncells3
        return (nx, ny, nz, self.geo.npres, self.row_off, len(self.run_first),
                self.run_first, self.run_len, self.run_sp, self.n_r,
                self.eta, self.rs, self.rc, self.scale, stream)


@functools.lru_cache(maxsize=32)
def _spec(ncells3, cell_caps, radial_cutoff, radial_eta, radial_rs,
          torchani) -> _PairSpec:
    return _PairSpec(_geometry(ncells3, cell_caps), radial_cutoff,
                     radial_eta, radial_rs, torchani)


def _check_inputs(spec: _PairSpec, ctr, z3, shift) -> None:
    geo = spec.geo
    for name, t, shape in (('ctr', ctr, (geo.ncells, geo.c, 3)),
                           ('z3', z3, (geo.ncells, 3, geo.ll)),
                           ('shift', shift, (geo.ncells, 4, 3))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be float32 {list(shape)}, got '
                             f'{t.dtype} {tuple(t.shape)}')
    _kernels.require_cuda(ctr, z3, shift)


def pair_radial_fwd_cuda(ctr, z3, shift, spec: _PairSpec):
    """Launch the forward kernel: ``(out_a, out_b)``."""
    _check_inputs(spec, ctr, z3, shift)
    geo = spec.geo
    out_a = torch.empty(geo.ncells, geo.c, spec.out_w, dtype=torch.float32,
                        device=ctr.device)
    out_b = torch.empty(geo.ncells, 4, spec.out_w, geo.ll,
                        dtype=torch.float32, device=ctr.device)
    _kernels.launch('pair_radial_fwd', ctr.data_ptr(), z3.data_ptr(),
                    shift.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                    *spec.scalars(_kernels.stream_handle(ctr.device)))
    return out_a, out_b


def pair_radial_bwd_cuda(ctr, z3, shift, ga, gb, spec: _PairSpec):
    """Launch the backward kernel: cotangents of ``ctr``, ``z3`` (the five
    per-offset planes summed) and ``shift``."""
    _check_inputs(spec, ctr, z3, shift)
    geo = spec.geo
    if (ga.dtype != torch.float32 or gb.dtype != torch.float32
            or tuple(ga.shape) != (geo.ncells, geo.c, spec.out_w)
            or tuple(gb.shape) != (geo.ncells, 4, spec.out_w, geo.ll)):
        raise ValueError('cotangents must be float32 [ncells, c, P*R] and '
                         '[ncells, 4, P*R, L]')
    _kernels.require_cuda(ga, gb)
    dctr = torch.empty_like(ctr)
    dz5 = torch.empty(5, geo.ncells, 3, geo.ll, dtype=torch.float32,
                      device=ctr.device)
    dsh = torch.empty_like(shift)
    _kernels.launch('pair_radial_bwd', ctr.data_ptr(), z3.data_ptr(),
                    shift.data_ptr(), ga.data_ptr(), gb.data_ptr(),
                    dctr.data_ptr(), dz5.data_ptr(), dsh.data_ptr(),
                    *spec.scalars(_kernels.stream_handle(ctr.device)))
    return dctr, dz5.sum(0), dsh


class PairRadialFunction(torch.autograd.Function):
    """Kernel forward; recompute-based kernel backward (only the inputs are
    saved, as in the Pallas VJP)."""

    @staticmethod
    def forward(ctx, ctr, z3, shift, spec):
        ctx.save_for_backward(ctr, z3, shift)
        ctx.spec = spec
        return pair_radial_fwd_cuda(ctr, z3, shift, spec)

    @staticmethod
    def backward(ctx, ga, gb):
        ctr, z3, shift = ctx.saved_tensors
        spec = ctx.spec
        geo = spec.geo
        if ga is None:
            ga = ctr.new_zeros(geo.ncells, geo.c, spec.out_w)
        if gb is None:
            gb = ctr.new_zeros(geo.ncells, 4, spec.out_w, geo.ll)
        dctr, dz3, dsh = pair_radial_bwd_cuda(ctr, z3, shift, ga.contiguous(),
                                              gb.contiguous(), spec)
        return dctr, dz3, dsh, None


def pair_radial(ctr: torch.Tensor, z3: torch.Tensor, shift: torch.Tensor,
                radial_cutoff: float, radial_eta: Sequence[float],
                radial_rs: Sequence[float], ncells3, cell_caps,
                torchani: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out_a, out_b)`` of the z-pair kernel: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if ctr.device.type == 'cpu':
        return pair_radial_plain(ctr, z3, shift, radial_cutoff, radial_eta,
                                 radial_rs, ncells3, cell_caps, torchani)
    if ctr.device.type != 'cuda':
        raise ValueError(f'no pair radial kernel for device {ctr.device}')
    spec = _spec(tuple(int(x) for x in ncells3),
                 tuple(int(x) for x in cell_caps), float(radial_cutoff),
                 tuple(float(x) for x in radial_eta),
                 tuple(float(x) for x in radial_rs), bool(torchani))
    return PairRadialFunction.apply(ctr.contiguous(), z3.contiguous(),
                                    shift.contiguous(), spec)


def pair_inputs(slots: torch.Tensor, box: torch.Tensor, ncells3,
                cell_caps) -> Tuple[torch.Tensor, ...]:
    """The kernel's inputs from the slot positions ``slots [ncells * c, 3]``:
    centers ``[ncells, c, 3]``, z-triples ``[ncells, 3, L]`` and the
    half-offset image shifts ``[ncells, 4, 3]`` (elementwise products, no
    matmul, as in the Pallas host code)."""
    ncells3 = tuple(int(x) for x in ncells3)
    c = sum(int(x) for x in cell_caps)
    ncells = int(np.prod(ncells3))
    ff = torch.as_tensor(_xy_shift_factors(ncells3), device=slots.device,
                         dtype=slots.dtype)
    shift = ff[..., 0:1] * box[0] + ff[..., 1:2] * box[1]
    return (slots.reshape(ncells, c, 3),
            _build_z3(slots, box, ncells3, cell_caps), shift)


def pair_radial_aev(slots: torch.Tensor, box: torch.Tensor, ncells3,
                    cell_caps: Tuple[int, ...], radial_cutoff: float,
                    radial_eta: Sequence[float], radial_rs: Sequence[float],
                    torchani: bool, plain: bool = False) -> torch.Tensor:
    """Radial AEV ``[ncells, c, P*R]`` in cell-slot space from the
    species-sub-blocked slot positions ``slots [ncells * c, 3]`` (wrapped
    primary-box positions, empty slots at FAR); differentiable in ``slots``
    and ``box``. ``plain`` runs the plain version on any device."""
    ncells3 = tuple(int(x) for x in ncells3)
    cell_caps = tuple(int(x) for x in cell_caps)
    ctr, z3, shift = pair_inputs(slots, box, ncells3, cell_caps)
    fn = pair_radial_plain if plain else pair_radial
    out_a, out_b = fn(ctr, z3, shift, radial_cutoff, radial_eta, radial_rs,
                      ncells3, cell_caps, torchani)
    return out_a + _fold_b(out_b, ncells3, cell_caps, out_a.shape[2])
