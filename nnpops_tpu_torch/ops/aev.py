"""ANI symmetry functions (port of ``nnpops_tpu.ops.aev``): the dense AEV
over a per-atom neighbor list (``compute_aev``, ``aev_forward``), the AEV
from a payload-carrying neighbor list (``compute_aev_from_payload``), and
the layout helpers every AEV path shares.

The math is the JAX package's term by term: the cosine cutoff, the radial
``fc(r) exp(-eta (r - rs)^2)`` summed per neighbor species, the angular
``fc(r1) fc(r2) (1 + cos(theta - ts))^zeta exp(-eta (rmean - rs)^2)``
summed per unordered species pair, the torchani-mode radial x0.25 and dot
x0.95, and the ``2^(1 - zeta)`` scale. Shapes are static: neighbor lists
are padded to capacity K, angular lists to K_ang, and the triples are the
static triangular enumeration of K_ang. Every ``sqrt`` and division sees a
``where``-guarded operand, so padding puts no NaN into the gradient.

Where JAX clamps with ``jnp.clip`` or ``jnp.maximum``, the port takes
``torch.maximum``/``torch.minimum``: at a tie they split the gradient in
halves as JAX does, where ``torch.clamp`` would pass all of it (the
torchani-mode ``cos_t`` reaches its bound for exactly collinear triples).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ANIBasis
from ..geometry import cosine_cutoff, minimum_image
from .batched_nn import _DotBF16
from .compaction import compact_rows

# The JAX package's four TPU layouts of the payload path's angular sum. The
# port computes one formulation for all of them (see
# ``compute_aev_from_payload``).
ANGULAR_IMPLS = ('ordered3', 'dense', 'pair', 'ordered2')


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


def dense_neighbor_list(num_atoms: int) -> np.ndarray:
    """The all-atoms neighbor list: for each atom every other atom,
    [N, N-1] int32 (the O(N^2) regime of small molecules)."""
    n = num_atoms
    idx = np.arange(n, dtype=np.int32)
    full = np.broadcast_to(idx, (n, n))
    mask = full != idx[:, None]
    return full[mask].reshape(n, n - 1).copy()


@functools.lru_cache(maxsize=32)
def _dense_neighbors(num_atoms: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(dense_neighbor_list(num_atoms), device=device).long()


@functools.lru_cache(maxsize=32)
def _triangle(k: int, device: torch.device):
    """The (j < k) lane pairs of a K-lane list, as two int64 index tensors."""
    jj, kk = np.triu_indices(k, k=1)
    return (torch.as_tensor(jj, device=device).long(),
            torch.as_tensor(kk, device=device).long())


@functools.lru_cache(maxsize=16)
def _pair_tables(num_species: int, device: torch.device):
    """(flat [S*S] ordered-pair -> unordered-pair index, [P, S*S] 0/1 fold
    of the ordered species basis into the unordered one)."""
    table = species_pair_index(num_species).reshape(-1)
    fold = np.zeros((int(table.max()) + 1, table.size), np.float32)
    fold[table, np.arange(table.size)] = 1.0
    return (torch.as_tensor(table, device=device).long(),
            torch.as_tensor(fold, device=device))


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """A small constant tensor on ``like``'s device and dtype, made once."""
    from .aev_blocked import device_constant   # (import cycle)
    return device_constant(tuple(float(v) for v in np.ravel(values)),
                           like.dtype, like.device)


def _pow(base: torch.Tensor, exponent) -> torch.Tensor:
    """``base ** exponent`` for base >= 0 with a finite value and gradient at
    0 (JAX's ``maximum`` then ``power``)."""
    return torch.pow(torch.maximum(base, _const((0.0,), base)), exponent)


def _onehot(index: torch.Tensor, num: int,
            weight: torch.Tensor) -> torch.Tensor:
    """``one_hot(index, num) * weight[..., None]`` in ``weight``'s dtype,
    made by one scatter (no int64 intermediate)."""
    out = weight.new_zeros(index.shape + (num,))
    return out.scatter_(-1, index[..., None], weight[..., None])


def _triple_terms(basis: ANIBasis, d1, d2, r1, r2,
                  tri_valid) -> torch.Tensor:
    """The angular terms ``[..., A]`` of the triples (deltas ``d1``, ``d2``
    and their guarded lengths ``r1``, ``r2``); 0 where ``tri_valid`` is
    False."""
    ra = basis.angular_cutoff
    dot = torch.where(tri_valid, torch.sum(d1 * d2, -1), 0.0)
    # The angle enters only through cos(theta - ts): work with (cos, sin)
    # and the addition formula. torchani mode: cos = 0.95 dot / (r1 r2),
    # sin = sqrt(1 - cos^2) >= 0.31; publication mode: the exact angle, sin
    # from the eps-guarded cross product.
    r1r2 = r1 * r2
    if basis.torchani:
        bound = _const((0.95,), dot)
        cos_t = torch.minimum(torch.maximum(0.95 * dot / r1r2, -bound), bound)
        sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    else:
        cos_t = dot / r1r2
        cross = torch.linalg.cross(d1, d2)
        cross_sq = torch.where(tri_valid, torch.sum(cross * cross, -1), 1.0)
        sin_t = torch.sqrt(torch.maximum(cross_sq, _const((1e-12,), cross_sq))
                           ) / r1r2
    r_mean = 0.5 * (r1 + r2)
    fc2 = cosine_cutoff(r1, ra) * cosine_cutoff(r2, ra)
    if basis.angular_rs_grid is not None:
        # Factored product grid (one eta and zeta): the Z theta-shift and R
        # radial-shift factors apart, combined by an outer product in the
        # from_grids layout (rs-major, then ts).
        ts = np.asarray(basis.angular_thetas_grid, np.float32)
        cos_tm = (cos_t[..., None] * _const(np.cos(ts), dot)
                  + sin_t[..., None] * _const(np.sin(ts), dot))     # [..., Z]
        cos_pow = _pow(1.0 + cos_tm, basis.angular_zeta[0])
        shifted = r_mean[..., None] - _const(basis.angular_rs_grid, dot)
        exp_term = fc2[..., None] * torch.exp(
            -basis.angular_eta[0] * shifted * shifted)              # [..., R]
        tri = (exp_term[..., :, None] * cos_pow[..., None, :]).flatten(-2)
    else:
        ts = np.asarray(basis.angular_thetas, np.float32)
        cos_tm = (cos_t[..., None] * _const(np.cos(ts), dot)
                  + sin_t[..., None] * _const(np.sin(ts), dot))
        cos_term = _pow(1.0 + cos_tm, _const(basis.angular_zeta, dot))
        shifted = r_mean[..., None] - _const(basis.angular_rs, dot)
        tri = fc2[..., None] * cos_term * torch.exp(
            -_const(basis.angular_eta, dot) * shifted * shifted)
    return torch.where(tri_valid[..., None], tri, 0.0)


def _zeta_scale(basis: ANIBasis, like: torch.Tensor) -> torch.Tensor:
    """The per-function ``2^(1 - zeta)`` angular scale, [A]."""
    return torch.pow(2.0, 1.0 - _const(basis.angular_zeta, like))


def _radial_pair(basis: ANIBasis, r: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """``fc(r) exp(-eta (r - rs)^2)`` per lane, [..., R]; 0 off ``valid``
    (``r`` is already guarded there)."""
    rc = basis.radial_cutoff
    shifted = r[..., None] - _const(basis.radial_rs, r)
    term = cosine_cutoff(r, rc)[..., None] * torch.exp(
        -_const(basis.radial_eta, r) * shifted * shifted)
    return torch.where(valid[..., None], term, 0.0)


def compute_aev(positions: torch.Tensor, species: torch.Tensor,
                basis: ANIBasis, box: Optional[torch.Tensor] = None,
                neighbors: Optional[torch.Tensor] = None,
                angular_capacity: Optional[int] = None,
                centers: Optional[torch.Tensor] = None) -> AEV:
    """Radial and angular symmetry functions of every atom (or of
    ``centers``).

    Args:
      positions: [N, 3] float positions.
      species: [N] integer species in [0, num_species).
      basis: the symmetry-function basis.
      box: optional [3, 3] reduced box vectors (periodic systems).
      neighbors: optional [N, K] integer neighbor candidates padded with
        the sentinel N; directed, and may hold atoms beyond the cutoff
        (masked here). Defaults to the all-atoms list.
      angular_capacity: cap on each atom's angular neighbors (default K):
        the neighbors inside the angular cutoff are compacted to the front
        in list order (``compact_rows``) and any beyond the cap are dropped.
      centers: optional [Nc] atom indices: only these atoms' rows are
        computed, against all positions (the hook of atom-axis sharding).

    Returns:
      AEV(radial [Nc, S*R], angular [Nc, P*A]) in the reference layout.
    """
    num_atoms = positions.shape[0]
    dev, dtype = positions.device, positions.dtype
    s = basis.num_species
    species = torch.as_tensor(species, device=dev).long()
    if neighbors is None:
        neighbors = _dense_neighbors(num_atoms, dev)
    neighbors = torch.as_tensor(neighbors, device=dev).long()
    center_positions = positions
    if centers is not None:
        centers = torch.as_tensor(centers, device=dev).long()
        neighbors = neighbors.index_select(0, centers)
        center_positions = positions.index_select(0, centers)
    nc, k = neighbors.shape
    k_ang = min(angular_capacity if angular_capacity is not None else k, k)
    rc, ra = basis.radial_cutoff, basis.angular_cutoff

    in_range = neighbors < num_atoms
    safe_idx = torch.where(in_range, neighbors, 0)
    # delta[n, k] points from atom n to its neighbor.
    delta = positions.index_select(0, safe_idx.reshape(-1)).reshape(
        nc, k, 3) - center_positions[:, None, :]
    delta = minimum_image(delta, box)
    r2 = torch.sum(delta * delta, -1)

    # ---- Radial block: per-lane terms contracted with the neighbors'
    # species one-hot.
    valid_r = in_range & (r2 < rc * rc)
    r = torch.sqrt(torch.where(valid_r, r2, 1.0))
    radial_pair = _radial_pair(basis, r, valid_r)                  # [Nc, K, R]
    nbr_species = species.index_select(0, safe_idx.reshape(-1)).reshape(nc, k)
    onehot = _onehot(nbr_species, s, valid_r.to(dtype))            # [Nc, K, S]
    radial = torch.bmm(onehot.transpose(1, 2), radial_pair)        # [Nc, S, R]
    if basis.torchani:
        radial = radial * 0.25

    # ---- Angular block: each atom's angular-cutoff neighbors compacted to
    # the front of a K_ang list, then the static triangle of lane pairs.
    valid_a = in_range & (r2 < ra * ra)
    if k_ang < k:
        take, ang_valid = compact_rows(valid_a, k_ang)
        take = take.long()
        ang_idx = torch.gather(safe_idx, 1, take)
        ang_delta = torch.gather(delta, 1, take[..., None].expand(-1, -1, 3))
    else:
        ang_idx, ang_valid, ang_delta = safe_idx, valid_a, delta
    jj, kk = _triangle(k_ang, dev)
    d1 = ang_delta.index_select(1, jj)                             # [Nc, T, 3]
    d2 = ang_delta.index_select(1, kk)
    tri_valid = ang_valid.index_select(1, jj) & ang_valid.index_select(1, kk)
    r1 = torch.sqrt(torch.where(tri_valid, torch.sum(d1 * d1, -1), 1.0))
    r2_ = torch.sqrt(torch.where(tri_valid, torch.sum(d2 * d2, -1), 1.0))
    tri_term = _triple_terms(basis, d1, d2, r1, r2_, tri_valid)    # [Nc, T, A]

    # Unordered-species-pair one-hot [Nc, T, P], contracted over triples.
    table, _ = _pair_tables(s, dev)
    sp = species.index_select(0, ang_idx.reshape(-1)).reshape(nc, k_ang)
    ordered = sp.index_select(1, jj) * s + sp.index_select(1, kk)
    pair_idx = table.index_select(0, ordered.reshape(-1)).reshape(ordered.shape)
    pair_onehot = _onehot(pair_idx, basis.num_species_pairs,
                          tri_valid.to(dtype))
    angular = torch.bmm(pair_onehot.transpose(1, 2), tri_term)     # [Nc, P, A]
    angular = angular * _zeta_scale(basis, angular)
    return AEV(radial.reshape(nc, -1), angular.reshape(nc, -1))


def max_angular_neighbors(payload, angular_cutoff: float) -> torch.Tensor:
    """The true per-atom maximum of neighbors inside the angular cutoff, []
    int32: compare it with the ``angular_capacity`` that
    :func:`compute_aev_from_payload` truncates to (it keeps the K_ang
    nearest and drops the rest)."""
    within = payload.mask & (payload.distances < angular_cutoff)
    return torch.max(torch.sum(within, 1, dtype=torch.int32))


def compute_aev_from_payload(payload, basis: ANIBasis,
                             angular_capacity: int,
                             chunk_size: Optional[int] = None,
                             contraction_dtype=None,
                             angular_impl: str = 'ordered3') -> AEV:
    """The AEV from a payload-carrying neighbor list (``CellList.
    build_payload`` or ``payload_from_selection``) whose features are the
    per-neighbor species one-hot [N, K, S]. Same math as
    :func:`compute_aev`.

    The angular list keeps each atom's K_ang nearest neighbors inside the
    angular cutoff: a stable sort of a gradient-free distance key (invalid
    lanes at infinity, so ties keep lane order), then one gather per
    payload field. The species scatter runs in the ordered species basis
    (the outer product of the two lanes' one-hots, S*S columns) and folds
    into the unordered pairs at the end.

    ``chunk_size``: process the atoms in blocks of this many rows (the
    last one shorter), which bounds the forward's live [chunk, T, A]
    intermediates (the unchunked angular block of a 26k-atom box is over
    a GB); under autograd each block still keeps what its backward needs
    (a 26,010-atom force step at chunk 512 peaked at 7.6 GiB on an H100).

    ``contraction_dtype``: ``torch.bfloat16`` rounds the operands of the
    species-scatter contractions to bf16 (the one-hots stay exact) and
    multiplies in f32, both passes (``_DotBF16``); None is f32.

    ``angular_impl``: the JAX package's four TPU layouts of the angular sum,
    'ordered3' (its default), 'dense', 'pair' and 'ordered2'. Each name
    runs the one formulation above; any other value raises ValueError.

    The one-hot features are species constants and enter without a
    gradient.
    """
    if angular_impl not in ANGULAR_IMPLS:
        raise ValueError(f'angular_impl={angular_impl!r} not in '
                         f'{ANGULAR_IMPLS}')
    fields = (payload.deltas, payload.distances, payload.features.detach(),
              payload.mask)
    if chunk_size is None or payload.distances.shape[0] <= chunk_size:
        return _payload_aev(*fields, basis, angular_capacity,
                            contraction_dtype)
    parts = [_payload_aev(*chunk, basis, angular_capacity, contraction_dtype)
             for chunk in zip(*(torch.split(x, chunk_size) for x in fields))]
    return AEV(torch.cat([p.radial for p in parts]),
               torch.cat([p.angular for p in parts]))


def _payload_aev(deltas, r, onehot, mask, basis: ANIBasis,
                 angular_capacity: int, contraction_dtype) -> AEV:
    n, k = r.shape
    s = basis.num_species
    rc, ra = basis.radial_cutoff, basis.angular_cutoff
    if contraction_dtype == torch.bfloat16:
        contract = _DotBF16.apply
    elif contraction_dtype is None:
        contract = torch.matmul
    else:
        raise ValueError(f'contraction_dtype={contraction_dtype!r}: None or '
                         'torch.bfloat16')

    # ---- Radial block. Re-mask by the true radial cutoff: the payload may
    # have been built with a Verlet skin (cell cutoff = rc + skin).
    mask = mask & (r < rc)
    radial_pair = _radial_pair(basis, torch.where(mask, r, 1.0), mask)
    radial = contract((onehot * mask[..., None]).transpose(1, 2),
                      radial_pair)                                 # [N, S, R]
    if basis.torchani:
        radial = radial * 0.25

    # ---- Angular block: the K_ang nearest angular neighbors.
    k_ang = min(angular_capacity, k)
    valid_a = mask & (r < ra)
    key = torch.where(valid_a, r.detach(), float('inf'))
    key_s, src = torch.sort(key, dim=1, stable=True)
    ang_valid = torch.isfinite(key_s[:, :k_ang])
    take = src[:, :k_ang]

    def lanes(x):
        got = torch.gather(x, 1, take[..., None].expand(-1, -1, x.shape[2]))
        return torch.where(ang_valid[..., None], got, 0.0)

    ang_delta, ang_oh = lanes(deltas), lanes(onehot)
    r_a = torch.where(ang_valid, torch.gather(r, 1, take), 1.0)
    dev = r.device
    jj, kk = _triangle(k_ang, dev)
    tri_valid = ang_valid.index_select(1, jj) & ang_valid.index_select(1, kk)
    tri_term = _triple_terms(basis, ang_delta.index_select(1, jj),
                             ang_delta.index_select(1, kk),
                             r_a.index_select(1, jj), r_a.index_select(1, kk),
                             tri_valid)                            # [N, T, A]

    # The ordered species pair of every triple (oh1 x oh2, S*S columns),
    # contracted over triples, then folded: for s1 < s2 the two ordered
    # entries sum, the diagonal passes through.
    oh1 = ang_oh.index_select(1, jj)
    oh2 = ang_oh.index_select(1, kk) * tri_valid[..., None]
    outer = (oh1[..., :, None] * oh2[..., None, :]).flatten(-2)    # [N, T, S*S]
    ordered = contract(outer.transpose(1, 2), tri_term)            # [N, S*S, A]
    _, fold = _pair_tables(s, dev)
    angular = torch.matmul(fold.to(ordered.dtype), ordered)        # [N, P, A]
    angular = angular * _zeta_scale(basis, angular)
    return AEV(radial.reshape(n, -1), angular.reshape(n, -1))


def aev_forward(positions, species, basis: ANIBasis, box=None, neighbors=None,
                angular_capacity=None, centers=None) -> torch.Tensor:
    """The concatenated [N, aev_length] feature matrix (radial || angular)
    that the atomic networks read."""
    radial, angular = compute_aev(positions, species, basis, box, neighbors,
                                  angular_capacity, centers)
    return torch.cat([radial, angular], 1)
