"""The PME direct-space window kernel (``csrc/pme_window.cu``), forward and
backward, its wrapper, autograd Function and plain PyTorch version, and its
host side (port of ``nnpops_tpu/ops/pallas_pme.py``).

The direct-space energy of every atom of a cell is an erfc-damped sum over
the cell's dense 27-cell candidate window; there is no pair list. Per cell
(``nx * ny * nz`` cells of at least the cutoff, capacity ``c``):

* ``candx/candy/candz/candq`` ``[ncells, kk]``, ``kk = 27 c``: the window's
  slot positions and charges, stencil-entry-major (entry
  ``(ox+1)*9 + (oy+1)*3 + (oz+1)``, then slot rank), periodic image shifts
  applied, empty slots at FAR with charge 0;
* ``centers`` ``[ncells, c, 4]``: the cell's own slots (x, y, z, q);
* ``excl`` ``[ncells, c, E]`` int32: the global slot ids each center row
  skips, -1 for none (``E >= 1``: a table of -1 when there are no
  exclusions, as in the JAX package);
* output ``[ncells, c]``: ``1/2 ke q_i sum_l q_l erfc(alpha r)/r`` over the
  lanes inside the cutoff that are neither the row's own slot nor excluded
  (each directed pair once, hence the 1/2). Lane slot ids come from the
  cell id and the lane index.

erfc is the Abramowitz and Stegun 7.1.26 polynomial in the kernel and the
plain version alike, so the two agree to f32 rounding; the pair path
(``ops.pme``) keeps ``torch.erfc``.

One contract the port adds, as for the window radial kernel: a center at or
beyond ``EMPTY_ROW`` (FAR/2) is an empty slot whose row is 0 with no pair
evaluated. The Pallas kernel pairs such rows with the empty lanes of their
own cell, where the charges (0) zero every term and cotangent, so every
output and cotangent agrees.

Host side: :func:`plan_pme_window` (equal to the JAX planner),
:func:`pme_direct_window` (the cell sort, the slot fill at FAR with charge
0 and the drop past capacity, the exclusion slot table, the window),
:func:`pme_window_overflow` (the soft-failure count: the JAX package's
``pme_window_occupancy`` and, for a bucketed plan,
``pme_window_count_overflow`` folded in, from one cell placement). The
cell ids follow JAX's order of operations (a LU inverse of the box, f32
floor and truncation), so the occupancy counts equal its.

Bucketing: the JAX package splits the cells into big and small occupancy
classes and launches the Pallas kernel once per class, so the TPU's uniform
grid skips padded center rows. The port runs one launch over all cells
(empty rows cost a test each); a 4-tuple plan's ``small_cap``/``num_big``
feed only the overflow channel. The energy equals JAX's whenever that
channel reports no overflow; in the flagged overflow state JAX drops the
rows of the surplus big cells past ``small_cap`` and the port does not
(ROADMAP C).

Dispatch: a CPU tensor runs :func:`pme_window_plain` (gradients by
autograd, any order); a CUDA tensor launches the forward kernel, and the
backward kernel under autograd (first order, as the Pallas VJP), or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import _kernels
from ..geometry import box_transform
from ..neighbors.cell_list import _perpendicular_widths
from ..neighbors.window import _grid_device_tables, _scatter, _shift_planes
from .aev_blocked import device_constant
from .cuda_window import EMPTY_ROW, FAR

Tensor = torch.Tensor

# Abramowitz & Stegun 7.1.26 erfc coefficients.
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def erfc_poly(x: Tensor) -> Tensor:
    """erfc(x) for x >= 0 (A&S 7.1.26, |eps| <= 1.5e-7)."""
    t = 1.0 / (1.0 + _AS_P * x)
    poly = _AS_A[4]
    for a in (_AS_A[3], _AS_A[2], _AS_A[1], _AS_A[0]):
        poly = poly * t + a
    return poly * t * torch.exp(-x * x)


# ---------------------------------------------------------------------------
# Host planner and soft-failure counts.

def plan_pme_window(box, cutoff: float, positions, margin: float = 1.25,
                    bucket: bool = False):
    """(ncells3, capacity) for the window direct path, or (None, None) when
    the box is under 3 cells wide; capacity from the TRUE max cell
    occupancy of ``positions`` times ``margin``, rounded up to 8.
    ``bucket``: the 4-tuple (ncells3, capacity, small_cap, num_big) of the
    JAX planner (small_cap from the 90th-percentile occupancy, num_big 1.5x
    the observed big cells + 4), or (ncells3, capacity, None, None) when no
    split pays. numpy, equal to the JAX planner."""
    box_np = np.asarray(box, np.float64)
    widths = _perpendicular_widths(box_np)
    nc = np.maximum(np.floor(widths / float(cutoff)).astype(int), 1)
    if (nc < 3).any():
        return (None, None, None, None) if bucket else (None, None)
    nx, ny, nz = (int(v) for v in nc)
    frac = np.asarray(positions, np.float64) @ np.linalg.inv(box_np)
    frac -= np.floor(frac)
    cell3 = np.minimum((frac * nc).astype(int), nc - 1)
    cid = (cell3[:, 0] * ny + cell3[:, 1]) * nz + cell3[:, 2]
    occ = np.bincount(cid, minlength=nx * ny * nz)
    cap = int(np.ceil(int(occ.max()) * margin)) + 1
    cap = -(-cap // 8) * 8
    if not bucket:
        return (nx, ny, nz), cap
    small = int(np.ceil(np.percentile(occ, 90) * 1.1)) + 1
    small = -(-small // 8) * 8
    nbig = min(len(occ), int(np.ceil(np.sum(occ > small) * 1.5)) + 4)
    if small >= cap or nbig >= len(occ):
        return (nx, ny, nz), cap, None, None
    return (nx, ny, nz), cap, small, nbig


def _cells(positions: Tensor, box: Tensor, ncells3):
    """(floor of the fractional coordinates [N, 3], cell id [N] int64) on
    the window grid, in the JAX package's order of operations."""
    nx, ny, nz = (int(v) for v in ncells3)
    frac = box_transform(positions, torch.linalg.inv_ex(box).inverse)
    floor = torch.floor(frac)
    grid = device_constant((nx, ny, nz), torch.int32, positions.device)
    cell3 = torch.clamp((((frac - floor) * grid).to(torch.int32)),
                        torch.zeros_like(grid), grid - 1).long()
    return floor, (cell3[:, 0] * ny + cell3[:, 1]) * nz + cell3[:, 2]


def pme_window_overflow(positions: Tensor, box: Tensor, window_plan) -> Tensor:
    """The window direct path's soft-failure count (int32 device scalar):
    the TRUE max atoms per cell on the plan's grid; for a bucketed 4-tuple
    plan, ``capacity + 1`` when that is larger and more cells hold more
    than ``small_cap`` atoms than the planned ``num_big``. Either way one
    ``count > capacity`` check covers the plan, as in the JAX package."""
    ncells3, capacity, *buck = window_plan
    with torch.no_grad():
        _, cell_id = _cells(positions, box, ncells3)
        # index_add, not bincount: bincount on a CUDA tensor synchronises.
        counts = torch.zeros(int(np.prod(ncells3)), dtype=torch.int32,
                             device=cell_id.device).index_add_(
            0, cell_id, torch.ones_like(cell_id, dtype=torch.int32))
        occ = torch.max(counts)
        if buck and buck[0] is not None:
            small_cap, num_big = buck
            n_big = torch.sum((counts > int(small_cap)).to(torch.int32))
            occ = torch.where(n_big <= int(num_big), occ,
                              torch.clamp(occ, min=int(capacity) + 1))
        return occ


# ---------------------------------------------------------------------------
# The kernel, its plain version, wrapper and autograd Function.

def _lane_slots(ncells3, c: int, device) -> Tensor:
    """[ncells, kk] global slot id of every window lane."""
    return _grid_device_tables(tuple(int(v) for v in ncells3), (int(c),),
                               device)[1]


def window_runs(c: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's run table: (first lane, lanes) of run e, the ``c``
    slots of stencil entry e in rank order (lanes ``[e*c, (e+1)*c)``). The
    kernel cuts each run at its last occupied lane (x < ``EMPTY_ROW``; the
    slots fill by rank) and skips, per center row, every run whose box of
    occupied positions lies beyond the cutoff."""
    first = np.arange(27, dtype=np.int64) * int(c)
    return first, np.full(27, int(c), np.int64)


@functools.lru_cache(maxsize=8)
def _run_arrays(c: int):
    """:func:`window_runs` as the kernel's ctypes host arrays."""
    return tuple((ctypes.c_int * 27)(*a.tolist()) for a in window_runs(c))


def pme_window_plain(candx: Tensor, candy: Tensor, candz: Tensor,
                     candq: Tensor, centers: Tensor, excl: Tensor, ncells3,
                     cutoff: float, alpha: float, coulomb: float) -> Tensor:
    """Plain version of the kernel, differentiable by autograd: dense
    ``[ncells, c, kk]`` math."""
    ncells, c = centers.shape[:2]
    dev = candx.device
    slot = _lane_slots(ncells3, c, dev)                        # [G, kk]
    dx = candx[:, None, :] - centers[:, :, 0:1]                # [G, c, kk]
    dy = candy[:, None, :] - centers[:, :, 1:2]
    dz = candz[:, None, :] - centers[:, :, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    self_slot = (torch.arange(ncells, device=dev)[:, None] * c
                 + torch.arange(c, device=dev)[None, :])       # [G, c]
    valid = ((d2 < float(cutoff) ** 2)
             & (slot[:, None, :] != self_slot[:, :, None])
             & (centers[:, :, 0:1] < EMPTY_ROW))
    for e in range(excl.shape[2]):
        valid = valid & (excl[:, :, e:e + 1] != slot[:, None, :])
    r = torch.sqrt(torch.clamp(d2, min=1e-12))
    w = torch.where(valid, erfc_poly(float(alpha) * r) / r, 0.0)
    return (0.5 * float(coulomb)) * centers[:, :, 3] * torch.sum(
        candq[:, None, :] * w, 2)


class _PmeSpec:
    """The scalars of one kernel configuration."""

    def __init__(self, ncells3, capacity, num_excl, cutoff, alpha, coulomb):
        self.ncells3 = tuple(int(v) for v in ncells3)
        self.ncells = int(np.prod(self.ncells3))
        self.c = int(capacity)
        self.kk = 27 * self.c
        self.ne = int(num_excl)
        self.cutoff, self.alpha, self.coulomb = (float(cutoff), float(alpha),
                                                 float(coulomb))
        self.run_first, self.run_len = _run_arrays(self.c)

    def scalars(self, stream: int):
        return (self.ncells, *self.ncells3, self.c, self.ne, self.run_first,
                self.run_len, self.cutoff, self.alpha, self.coulomb, stream)


def _check_inputs(spec: _PmeSpec, candx, candy, candz, candq, centers, excl):
    for name, t in (('candx', candx), ('candy', candy), ('candz', candz),
                    ('candq', candq)):
        if t.dtype != torch.float32 or tuple(t.shape) != (spec.ncells, spec.kk):
            raise ValueError(f'{name} must be float32 [{spec.ncells}, '
                             f'{spec.kk}], got {t.dtype} {tuple(t.shape)}')
    if (centers.dtype != torch.float32
            or tuple(centers.shape) != (spec.ncells, spec.c, 4)):
        raise ValueError(f'centers must be float32 [{spec.ncells}, {spec.c}, '
                         f'4], got {centers.dtype} {tuple(centers.shape)}')
    if (excl.dtype != torch.int32
            or tuple(excl.shape) != (spec.ncells, spec.c, spec.ne)):
        raise ValueError(f'excl must be int32 [{spec.ncells}, {spec.c}, '
                         f'{spec.ne}], got {excl.dtype} {tuple(excl.shape)}')
    _kernels.require_cuda(candx, candy, candz, candq, centers, excl)


def pme_window_fwd_cuda(candx, candy, candz, candq, centers, excl,
                        spec: _PmeSpec) -> Tensor:
    """Launch the forward kernel: ``[ncells, c]`` row energies."""
    _check_inputs(spec, candx, candy, candz, candq, centers, excl)
    out = torch.empty(spec.ncells, spec.c, dtype=torch.float32,
                      device=candx.device)
    _kernels.launch('pme_window_fwd', candx.data_ptr(), candy.data_ptr(),
                    candz.data_ptr(), candq.data_ptr(), centers.data_ptr(),
                    excl.data_ptr(), out.data_ptr(),
                    *spec.scalars(_kernels.stream_handle(candx.device)))
    return out


def pme_window_bwd_cuda(candx, candy, candz, candq, centers, excl, g,
                        spec: _PmeSpec):
    """Launch the backward kernel: cotangents of the four candidate planes
    ``[ncells, kk]`` and of the centers ``[ncells, c, 4]``."""
    _check_inputs(spec, candx, candy, candz, candq, centers, excl)
    if g.dtype != torch.float32 or tuple(g.shape) != (spec.ncells, spec.c):
        raise ValueError(f'cotangent must be float32 [{spec.ncells}, '
                         f'{spec.c}]')
    _kernels.require_cuda(g)
    dcand = torch.empty(4, spec.ncells, spec.kk, dtype=torch.float32,
                        device=candx.device)
    dctr = torch.empty_like(centers)
    _kernels.launch('pme_window_bwd', candx.data_ptr(), candy.data_ptr(),
                    candz.data_ptr(), candq.data_ptr(), centers.data_ptr(),
                    excl.data_ptr(), g.data_ptr(), dcand.data_ptr(),
                    dctr.data_ptr(),
                    *spec.scalars(_kernels.stream_handle(candx.device)))
    return dcand[0], dcand[1], dcand[2], dcand[3], dctr


class PmeWindowFunction(torch.autograd.Function):
    """Kernel forward; recompute-based kernel backward (only the inputs are
    saved, as in the Pallas VJP). First order."""

    @staticmethod
    def forward(ctx, candx, candy, candz, candq, centers, excl, spec):
        ctx.save_for_backward(candx, candy, candz, candq, centers, excl)
        ctx.spec = spec
        return pme_window_fwd_cuda(candx, candy, candz, candq, centers, excl,
                                   spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        candx, candy, candz, candq, centers, excl = ctx.saved_tensors
        grads = pme_window_bwd_cuda(candx, candy, candz, candq, centers,
                                    excl, g.contiguous(), ctx.spec)
        return (*grads, None, None)


def pme_window(candx: Tensor, candy: Tensor, candz: Tensor, candq: Tensor,
               centers: Tensor, excl: Tensor, ncells3, cutoff: float,
               alpha: float, coulomb: float) -> Tensor:
    """``[ncells, c]`` direct-space row energies (the counterpart of the
    Pallas ``pme_window`` function): the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if candx.device.type == 'cpu':
        return pme_window_plain(candx, candy, candz, candq, centers, excl,
                                ncells3, cutoff, alpha, coulomb)
    if candx.device.type != 'cuda':
        raise ValueError(f'no PME window kernel for device {candx.device}')
    spec = _PmeSpec(ncells3, centers.shape[1], excl.shape[2], cutoff, alpha,
                    coulomb)
    return PmeWindowFunction.apply(
        candx.contiguous(), candy.contiguous(), candz.contiguous(),
        candq.contiguous(), centers.contiguous(), excl.contiguous(), spec)


# ---------------------------------------------------------------------------
# The direct-space energy.

def pme_window_inputs(positions: Tensor, charges: Tensor, box: Tensor,
                      exclusions: Tensor, ncells3, capacity: int):
    """The kernel's inputs: (candx, candy, candz, candq, centers, excl).

    The cell sort, the slot map and the exclusion table take no gradient;
    positions enter as ``positions - wrap_shift`` (the frozen box multiple
    of each atom, constant) and charges as they are, through gathers whose
    adjoints are ``index_add``. Atoms past a cell's capacity are dropped
    (the sentinel slot ``cc + 1``); :func:`pme_window_overflow` reports
    them."""
    nx, ny, nz = (int(v) for v in ncells3)
    ncells = nx * ny * nz
    c = int(capacity)
    cc = ncells * c
    n = positions.shape[0]
    dev = positions.device
    with torch.no_grad():
        floor, cell_id = _cells(positions.detach(), box.detach(), ncells3)
        wrap_shift = box_transform(floor, box.detach())
        order = torch.argsort(cell_id, stable=True)
        sorted_id = cell_id[order]
        idx_n = torch.arange(n, device=dev)
        new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                             sorted_id[1:] != sorted_id[:-1]])
        seg_start = torch.cummax(torch.where(new_seg, idx_n, 0), 0).values
        rank = idx_n - seg_start
        slot = torch.where(rank < c, sorted_id * c + rank, cc + 1)
        slot_to_atom = _scatter(cc, slot, order, n)
        num_excl = exclusions.shape[1]
        if num_excl > 0:
            slot_of_atom = torch.empty_like(slot).index_copy_(0, order, slot)
            epad = torch.cat([slot_of_atom, slot_of_atom.new_full((1,), -1)])
            excl_ids = exclusions.long()
            excl_slots = epad[torch.where(excl_ids >= 0, excl_ids, n)]
            excl_table = _scatter(cc, slot_of_atom, excl_slots, -1).reshape(
                ncells, c, num_excl)
        else:
            excl_table = torch.full((ncells, c, 1), -1, dtype=torch.int64,
                                    device=dev)
    rows = torch.cat([positions - wrap_shift, charges[:, None]], 1)
    empty = torch.cat([positions.new_full((1, 3), FAR),
                       positions.new_zeros((1, 1))], 1)
    slots = torch.cat([rows, empty]).index_select(0, slot_to_atom)   # [cc, 4]
    f27, cand_slot = _grid_device_tables((nx, ny, nz), (c,), dev)
    win = (slots.t().index_select(1, cand_slot.reshape(-1))
           .reshape(4, ncells, cand_slot.shape[1]))
    shift = _shift_planes(f27.to(box.dtype), box, (c,))
    return (win[0] + shift[0], win[1] + shift[1], win[2] + shift[2], win[3],
            slots.reshape(ncells, c, 4), excl_table.to(torch.int32))


def pme_direct_window(positions: Tensor, charges: Tensor, box: Tensor,
                      exclusions: Tensor, cutoff: float, alpha: float,
                      coulomb: float, ncells3: Tuple[int, int, int],
                      capacity: int, plain: bool = False) -> Tensor:
    """Direct-space Ewald energy through the window kernel (without the
    exclusion compensation, which ``ops.pme`` subtracts), differentiable in
    positions and charges. One launch over all cells whatever the plan's
    bucketing; overflow of ``capacity`` is reported by
    :func:`pme_window_overflow`, not here. ``plain`` runs the plain version
    on any device."""
    fn = pme_window_plain if plain else pme_window
    return torch.sum(fn(*pme_window_inputs(positions, charges, box,
                                           exclusions, ncells3, capacity),
                        ncells3, cutoff, alpha, coulomb))
