// PME direct space over the dense 27-cell window, forward and backward,
// for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_pme.py:64
// make_pme_window_kernel: fwd_kernel (:177, pallas_call at :288/:292) and
// bwd_kernel (:199). Wrapper, autograd Function, plain PyTorch version,
// run table and host side: nnpops_tpu_torch/ops/cuda_pme.py (its
// docstring states the contract).
//
// Per cell a of the nx x ny x nz grid, every center row i (the cell's own
// slots, [ncells, c, 4] = x, y, z, q) is paired with the cell's window
// lanes l (four [ncells, kk] planes, kk = 27 c, stencil-entry-major, image
// shifts applied, empty slots at FAR with charge 0):
//   e_i = 1/2 ke q_i sum_l q_l erfc(alpha r_il) / r_il
// over the lanes with r_il^2 < rc^2 that are neither the center's own slot
// nor one of its E exclusion slot ids. A lane's global slot id is its
// stencil cell's id times c plus its rank, from the cell id and the lane
// index (lane_slot_ids at pallas_pme.py:135-152). erfc is the Abramowitz
// and Stegun 7.1.26 polynomial (|eps| <= 1.5e-7), as in the Pallas kernel
// and the plain version.
//
// What bounds it on the H100: the bytes of the four candidate planes
// (16 kk bytes a cell, 1.7 MB at 2,601 atoms) and, about as much, FP32
// operations: a distance and slot test a tested (center, lane) pair, and a
// pair inside the cutoff an rsqrt, an ex2 and an rcp (SFU) and the erfc
// polynomial, forward; the backward adds the derivative and both
// cotangents from the same evaluation. Each pair is tested once per
// direction (the sum is over directed pairs, hence the 1/2).
//
// Design (the walk is window_walk.cuh's): one block per cell, over all
// cells in one launch (the Pallas kernel's bucketing only trims padded
// center rows on the TPU's uniform grid), 32 warps while cells are fewer
// than SMs, else 16. The block stages the cell's window with every lane's
// slot id, cuts each stencil entry's run at its last occupied lane and
// boxes it, and stages the cell's centers, exclusion rows and row
// cotangents. A unit is (real center row, run group j: entries j, j + NL,
// ...); it skips the runs whose box lies beyond the cutoff, tests the rest
// 64 lanes at a time and queues the pairs that count; each queued pair is
// one thread's, evaluated once.
// - Forward (2 run groups): units go to the warps in turn; each unit's sum
//   is reduced over the warp into the row's partial, and the block sums a
//   row's partials in order.
// - Backward: one evaluation per pair feeds both sums. Warp (i, j) takes
//   group j of real rows i, i + NR, ...; the center's sum goes to the
//   unit's partial (reduced over the warp), the lane's is added into row
//   group i's shared-memory plane at the lane (within one row a lane
//   appears once, and only warp (i, j) writes group j's lanes of plane i).
//   The block sums the NR planes per lane and the NL partials per row in
//   order, and writes every output once. NL (from 2) grows until the
//   planes fit (two blocks an SM when cells outnumber SMs).
// No atomics; every sum runs in a fixed order, so both directions are
// bitwise repeatable. The slot and cutoff tests take the plain version's
// branches (d2 rounded op by op as PyTorch rounds it; the clamp of d2 at
// 1e-12). Intrinsics (inline PTX, flush to zero): rsqrt.approx for 1/r
// and r, ex2.approx for exp(-alpha^2 r^2), rcp.approx for the polynomial's
// 1/(1 + p x). Center rows at or beyond FAR/2 are empty slots: they write
// 0 and test no lane; empty lanes get 0.
#include <cuda_runtime.h>

#include <cstdint>

#include "window_walk.cuh"

namespace {

using walk::kEntries;
constexpr int kFwdGroups = 2;     // run groups of the forward
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

struct PmeParams {
  int ncells, nx, ny, nz, c, kk, ne, nl;
  float rc2, alpha, half_ke, two_al, nal2;   // nal2 = -alpha^2 log2(e)
  float inv_c;
  walk::RunTable runs;                       // run e: stencil entry e
};

// w = erfc(alpha r) / r and, for the backward, ex = exp(-alpha^2 r^2) and
// 1/r, of a pair at squared distance d2 (A&S 7.1.26, pallas_pme.py:55-61).
struct Pair {
  float w, ex, rinv;
};

__device__ __forceinline__ Pair pair_terms(float d2, const PmeParams& p) {
  const float m = fmaxf(d2, 1e-12f);
  Pair t;
  t.rinv = walk::rsqrt_approx(m);
  const float x = p.alpha * (m * t.rinv);
  t.ex = walk::ex2(p.nal2 * m);
  const float u = walk::rcp_approx(fmaf(0.3275911f, x, 1.f));
  float poly = 1.061405429f;
  poly = poly * u + -1.453152027f;
  poly = poly * u + 1.421413741f;
  poly = poly * u + -0.284496736f;
  poly = poly * u + 0.254829592f;
  t.w = poly * u * t.ex * t.rinv;
  return t;
}

// Id of the cell at stencil entry e of the cell at (ax, ay, az): entry
// (ox+1)*9 + (oy+1)*3 + (oz+1), periodic on the grid.
__device__ __forceinline__ int stencil_cell(int ax, int ay, int az, int e,
                                            const PmeParams& p) {
  int bx = ax + e / 9 - 1, by = ay + (e / 3) % 3 - 1, bz = az + e % 3 - 1;
  bx += bx < 0 ? p.nx : (bx >= p.nx ? -p.nx : 0);
  by += by < 0 ? p.ny : (by >= p.ny ? -p.ny : 0);
  bz += bz < 0 ? p.nz : (bz >= p.nz ? -p.nz : 0);
  return (bx * p.ny + by) * p.nz + bz;
}

// Shared memory of a kernel, as offsets from the dynamic __shared__ array:
// the stage with every lane's slot id, per warp a live-run table (64 ints)
// and queue (96 ints), the centers (x, y, z, q), the real rows and their
// count, the rows' cotangents, the cell's exclusion rows [c][ne], the
// partial row sums [c][nl][k], and the backward's planes [nr][4][kk].
struct Layout {
  walk::StageLayout stage;
  size_t tbl, queue, ctr, srow, nreal, g, excl, part, planes, bytes;
};

__host__ __device__ inline Layout layout(const PmeParams& p, int nw,
                                         bool bwd) {
  Layout o;
  size_t at = 0;
  o.stage = walk::stage_layout(at, p.kk, p.runs.nruns, true);
  o.tbl = walk::region(at, (size_t)256 * nw);
  o.queue = walk::region(at, (size_t)384 * nw);
  o.ctr = walk::region(at, (size_t)16 * p.c);
  o.srow = walk::region(at, (size_t)4 * p.c);
  o.nreal = walk::region(at, 4);
  o.g = walk::region(at, (size_t)4 * p.c);
  o.excl = walk::region(at, (size_t)4 * p.c * p.ne);
  o.part = walk::region(at, (size_t)(bwd ? 16 : 4) * p.c * p.nl);
  o.planes = bwd ? walk::region(at, (size_t)16 * p.kk * (nw / p.nl)) : 0;
  o.bytes = at;
  return o;
}

struct Tail {
  int *tbl, *queue, *srow, *nreal, *excl;
  float4* ctr;
  float *g, *part;
};

__device__ __forceinline__ Tail make_tail(unsigned char* smem,
                                          const Layout& o, int warp) {
  Tail t;
  t.tbl = reinterpret_cast<int*>(smem + o.tbl) + 64 * warp;
  t.queue = reinterpret_cast<int*>(smem + o.queue) + 96 * warp;
  t.ctr = reinterpret_cast<float4*>(smem + o.ctr);
  t.srow = reinterpret_cast<int*>(smem + o.srow);
  t.nreal = reinterpret_cast<int*>(smem + o.nreal);
  t.g = reinterpret_cast<float*>(smem + o.g);
  t.excl = reinterpret_cast<int*>(smem + o.excl);
  t.part = reinterpret_cast<float*>(smem + o.part);
  return t;
}

// Stages the window (occupied lanes with their slot ids), the cell's
// centers, exclusion rows and (backward) row cotangents, and lists the
// real rows.
__device__ __forceinline__ void stage(const float* __restrict__ cx,
                                      const float* __restrict__ cy,
                                      const float* __restrict__ cz,
                                      const float* __restrict__ cq,
                                      const float* __restrict__ centers,
                                      const int* __restrict__ excl,
                                      const float* __restrict__ g, int cell,
                                      const PmeParams& p, const walk::Stage& s,
                                      const Tail& t) {
  const size_t base = (size_t)cell * p.kk;
  const size_t rbase = (size_t)cell * p.c;
  const int az = cell % p.nz, axy = cell / p.nz;
  const int ay = axy % p.ny, ax = axy / p.ny;
  walk::stage_window(
      p.runs, s, p.kk,
      [&](int l) {
        return make_float4(cx[base + l], cy[base + l], cz[base + l],
                           cq[base + l]);
      },
      // Slot id of lane l: its stencil entry e's cell's id times c plus its
      // rank (e = l / c from the float reciprocal, exact for l < 2^21).
      [&](int l) {
        const int e = __float2int_rz(((float)l + 0.5f) * p.inv_c);
        return stencil_cell(ax, ay, az, e, p) * p.c + (l - e * p.c);
      },
      [&] {
        for (int r = threadIdx.x; r < p.c; r += blockDim.x) {
          const float* c = centers + 4 * (rbase + r);
          t.ctr[r] = make_float4(c[0], c[1], c[2], c[3]);
          if (g) t.g[r] = g[rbase + r];
        }
        for (int i = threadIdx.x; i < p.c * p.ne; i += blockDim.x)
          t.excl[i] = excl[rbase * p.ne + i];
      },
      [&] { walk::list_real_rows(t.ctr, p.c, t.srow, t.nreal); });
}

// Whether compacted lane pos pairs with center row `row` at c.
__device__ __forceinline__ bool pairs_with(const walk::Stage& s, int pos,
                                           float4 c, int self_sid,
                                           const int* ex, const PmeParams& p) {
  const float4 v = s.lane[pos];
  const float d2 = walk::dist2_rn(__fsub_rn(v.x, c.x), __fsub_rn(v.y, c.y),
                                  __fsub_rn(v.z, c.z));
  if (!(d2 < p.rc2)) return false;
  const int sid = s.tag[pos];
  if (sid == self_sid) return false;
  for (int e = 0; e < p.ne; ++e)
    if (ex[e] == sid) return false;
  return true;
}

__global__ void __launch_bounds__(walk::kMaxThreads)
pme_window_fwd_kernel(const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ cz,
                      const float* __restrict__ cq,
                      const float* __restrict__ centers,
                      const int* __restrict__ excl, float* __restrict__ out,
                      const PmeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = walk::warp_id(), lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const Layout o = layout(p, nw, false);
  const walk::Stage s = walk::make_stage(smem, o.stage, true);
  const Tail t = make_tail(smem, o, warp);
  const int cell = blockIdx.x;
  stage(cx, cy, cz, cq, centers, excl, nullptr, cell, p, s, t);

  // Units (real row, run group j: entries j, j + 2, ...), a warp each in
  // turn.
  const int nreal = *t.nreal;
  const int dri = nw / kFwdGroups, dj = nw % kFwdGroups;
  int ri = warp / kFwdGroups, j = warp % kFwdGroups;
  while (ri < nreal) {
    const int row = t.srow[ri];
    const float4 c = t.ctr[row];
    const int self_sid = cell * p.c + row;
    const int* ex = t.excl + row * p.ne;
    const walk::LiveRuns L = walk::live_runs(
        s, j, kFwdGroups, (kEntries - j + kFwdGroups - 1) / kFwdGroups, c.x,
        c.y, c.z, p.rc2, t.tbl);
    float acc = 0.f;
    walk::walk(
        L, t.queue,
        [&](int pos) { return pairs_with(s, pos, c, self_sid, ex, p); },
        [&](int pos, bool on) {
          if (!on) return;
          const float4 v = s.lane[pos];
          const float d2 = walk::dist2_rn(
              __fsub_rn(v.x, c.x), __fsub_rn(v.y, c.y), __fsub_rn(v.z, c.z));
          acc = fmaf(v.w, pair_terms(d2, p).w, acc);
        });
    acc = walk::warp_sum(acc);
    if (lane == 0) t.part[row * kFwdGroups + j] = acc;
    j += dj;
    ri += dri;
    if (j >= kFwdGroups) {
      j -= kFwdGroups;
      ++ri;
    }
  }
  __syncthreads();
  for (int row = threadIdx.x; row < p.c; row += blockDim.x) {
    const float4 c = t.ctr[row];
    float acc = 0.f;
    if (c.x < walk::kEmpty)
      for (int j = 0; j < kFwdGroups; ++j) acc += t.part[row * kFwdGroups + j];
    out[(size_t)cell * p.c + row] = p.half_ke * c.w * acc;
  }
}

__global__ void __launch_bounds__(walk::kMaxThreads)
pme_window_bwd_kernel(const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ cz,
                      const float* __restrict__ cq,
                      const float* __restrict__ centers,
                      const int* __restrict__ excl,
                      const float* __restrict__ g,
                      float* __restrict__ dcand,
                      float* __restrict__ dctr, const PmeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = walk::warp_id(), lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5, nr = nw / p.nl;
  const Layout o = layout(p, nw, true);
  const walk::Stage s = walk::make_stage(smem, o.stage, true);
  const Tail t = make_tail(smem, o, warp);
  float* planes = reinterpret_cast<float*>(smem + o.planes);
  const int cell = blockIdx.x;
  for (int k = threadIdx.x; k < 4 * nr * p.kk; k += blockDim.x)
    planes[k] = 0.f;
  stage(cx, cy, cz, cq, centers, excl, g, cell, p, s, t);

  if (warp < nr * p.nl) {
    const int i = warp / p.nl, j = warp - i * p.nl;
    const int nk = (kEntries - j + p.nl - 1) / p.nl;
    float* pl0 = planes + (size_t)i * 4 * p.kk;
    float* pl1 = pl0 + p.kk;
    float* pl2 = pl1 + p.kk;
    float* pl3 = pl2 + p.kk;
    const float two_al = p.two_al;
    const int nreal = *t.nreal;
    for (int ri = i; ri < nreal; ri += nr) {
      const int row = t.srow[ri];
      const float4 c = t.ctr[row];
      const float gh = p.half_ke * t.g[row];
      const int self_sid = cell * p.c + row;
      const int* ex = t.excl + row * p.ne;
      const walk::LiveRuns L =
          walk::live_runs(s, j, p.nl, nk, c.x, c.y, c.z, p.rc2, t.tbl);
      float gx = 0.f, gy = 0.f, gz = 0.f, gq = 0.f;
      walk::walk(
          L, t.queue,
          [&](int pos) { return pairs_with(s, pos, c, self_sid, ex, p); },
          [&](int pos, bool on) {
            if (!on) return;
            const float4 v = s.lane[pos];
            const float dx = __fsub_rn(v.x, c.x), dy = __fsub_rn(v.y, c.y),
                        dz = __fsub_rn(v.z, c.z);
            const Pair e = pair_terms(walk::dist2_rn(dx, dy, dz), p);
            // d/dr [erfc(al r)/r] = -(2 al/sqrt(pi) e^{-al^2 r^2} + w)/r
            const float dw = -(two_al * e.ex + e.w) * e.rinv;
            const float coef = gh * (c.w * v.w) * dw * e.rinv;
            const float ax = coef * dx, ay = coef * dy, az = coef * dz;
            const float ghw = gh * e.w;
            pl0[pos] += ax;
            pl1[pos] += ay;
            pl2[pos] += az;
            pl3[pos] += ghw * c.w;
            gx += ax;
            gy += ay;
            gz += az;
            gq += ghw * v.w;
          });
      gx = walk::warp_sum(gx);
      gy = walk::warp_sum(gy);
      gz = walk::warp_sum(gz);
      gq = walk::warp_sum(gq);
      if (lane == 0) {
        float* part = t.part + 4 * (row * p.nl + j);
        part[0] = gx;
        part[1] = gy;
        part[2] = gz;
        part[3] = gq;
      }
    }
  }
  __syncthreads();

  const size_t plane = (size_t)p.ncells * p.kk;
  const size_t base = (size_t)cell * p.kk;
  for (int l = threadIdx.x; l < p.kk; l += blockDim.x) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < nr; ++i) {
      const float* pl = planes + (size_t)i * 4 * p.kk + l;
#pragma unroll
      for (int a = 0; a < 4; ++a) v[a] += pl[a * p.kk];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) dcand[a * plane + base + l] = v[a];
  }
  for (int row = threadIdx.x; row < p.c; row += blockDim.x) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t.ctr[row].x < walk::kEmpty) {
      for (int j = 0; j < p.nl; ++j) {
#pragma unroll
        for (int a = 0; a < 4; ++a) v[a] += t.part[4 * (row * p.nl + j) + a];
      }
    }
    const size_t crow = (size_t)cell * p.c + row;
    dctr[crow * 4] = -v[0];
    dctr[crow * 4 + 1] = -v[1];
    dctr[crow * 4 + 2] = -v[2];
    dctr[crow * 4 + 3] = v[3];
  }
}

// The run table comes from the wrapper (window_runs in cuda_pme.py); it is
// checked here: 27 runs of c lanes that tile [0, kk) in order.
int make_params(PmeParams& p, int ncells, int nx, int ny, int nz, int c,
                int ne, const int* run_first, const int* run_len,
                double cutoff, double alpha, double coulomb) {
  if (nx < 3 || ny < 3 || nz < 3 || ncells != nx * ny * nz || c < 1 ||
      ne < 1 || cutoff <= 0 || alpha <= 0)
    return (int)cudaErrorInvalidValue;
  for (int e = 0; e < kEntries; ++e) {
    if (run_first[e] != e * c || run_len[e] != c)
      return (int)cudaErrorInvalidValue;
    p.runs.first[e] = run_first[e];
    p.runs.len[e] = run_len[e];
  }
  p.runs.nruns = kEntries;
  p.ncells = ncells;
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  p.c = c;
  p.kk = 27 * c;
  p.ne = ne;
  p.nl = kFwdGroups;
  p.rc2 = (float)(cutoff * cutoff);
  p.alpha = (float)alpha;
  p.half_ke = (float)(0.5 * coulomb);
  p.two_al = kTwoOverSqrtPi * p.alpha;
  p.nal2 = (float)(-alpha * alpha * 1.4426950408889634);
  p.inv_c = 1.f / (float)c;
  return 0;
}

}  // namespace

extern "C" {

int pme_window_fwd(const float* cx, const float* cy, const float* cz,
                   const float* cq, const float* centers, const int* excl,
                   float* out, int ncells, int nx, int ny, int nz, int c,
                   int ne, const int* run_first, const int* run_len,
                   double cutoff, double alpha, double coulomb,
                   void* stream) {
  PmeParams p;
  const int bad = make_params(p, ncells, nx, ny, nz, c, ne, run_first,
                              run_len, cutoff, alpha, coulomb);
  if (bad) return bad;
  const int nw = walk::block_warps(ncells);
  const size_t smem = layout(p, nw, false).bytes;
  cudaError_t err = walk::prepare(pme_window_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pme_window_fwd_kernel<<<ncells, 32 * nw, smem, (cudaStream_t)stream>>>(
      cx, cy, cz, cq, centers, excl, out, p);
  return (int)cudaGetLastError();
}

int pme_window_bwd(const float* cx, const float* cy, const float* cz,
                   const float* cq, const float* centers, const int* excl,
                   const float* g, float* dcand, float* dctr, int ncells,
                   int nx, int ny, int nz, int c, int ne,
                   const int* run_first, const int* run_len, double cutoff,
                   double alpha, double coulomb, void* stream) {
  PmeParams p;
  const int bad = make_params(p, ncells, nx, ny, nz, c, ne, run_first,
                              run_len, cutoff, alpha, coulomb);
  if (bad) return bad;
  // Run groups: the fewest whose planes fit, two blocks an SM when there
  // are more cells than SMs.
  const int nw = walk::block_warps(ncells);
  const size_t budget =
      nw == 32 ? (size_t)walk::kSmemLimit : (size_t)walk::kSmemLimit / 2 - 1024;
  int nl = 0;
  for (int k = 2; k <= nw && k <= kEntries; k <<= 1) {
    p.nl = k;
    const size_t smem = layout(p, nw, true).bytes;
    if (smem <= (size_t)walk::kSmemLimit && nl == 0) nl = k;
    if (smem <= budget) {
      nl = k;
      break;
    }
  }
  if (nl == 0) return (int)cudaErrorInvalidValue;
  p.nl = nl;
  const size_t smem = layout(p, nw, true).bytes;
  cudaError_t err = walk::prepare(pme_window_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pme_window_bwd_kernel<<<ncells, 32 * nw, smem, (cudaStream_t)stream>>>(
      cx, cy, cz, cq, centers, excl, g, dcand, dctr, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
