// Symmetric z-pair radial AEV, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_zpair.py:60
// _make_pair_kernels: fwd_kernel (pallas_call at :219) and bwd_kernel
// (:233). Wrapper, autograd Function, plain PyTorch version, run table and
// the host side (z-triple build, shifts, fold): nnpops_tpu_torch/ops/
// cuda_zpair.py.
//
// Semantics, per cell a of an nx x ny x nz grid with c species-sub-blocked
// slots (species s owns rows [row_off[s], row_off[s+1])):
// * lanes are z-triples: z3[b] holds, per species s, the slots of cells
//   (b, z-1 | z | z+1), L = 3c lanes, species s on [3 off_s, 3 off_{s+1});
// * the cell's center rows meet the z-triples of five columns b_d: the
//   self column (d = 0) and the half xy-offsets (1,0), (0,1), (1,1),
//   (1,-1), whose periodic image shift shift[a, d-1] is added to the
//   lanes; the self lane of row r (d = 0) is r + 2 off_s + cs;
// * a pair is valid when d2 < rc^2; fc = 0.5 cos(pi r / rc) + 0.5;
// * out_a[a, r, s_l*R + q] = scale * sum over the five columns and the
//   lanes of species s_l of fc * exp(-eta_q (r - rs_q)^2);
// * out_b[a, d-1, s_r*R + q, l] = scale * sum over the rows of species s_r
//   of the same term (the neighbour side of the four half offsets, folded
//   onto the neighbours' home cells by the wrapper).
// The backward recomputes the geometry and writes dctr [ncells, c, 3],
// one dz3 plane per column at the column's cell (dz5 [5, ncells, 3, L],
// summed by the wrapper) and the shift cotangent dsh [ncells, 4, 3].
// Centers at or beyond FAR/2 are empty slots: their rows are 0 and they
// evaluate no pair (the Pallas kernel pairs them with the empty lanes of
// their own column, d = 0, and writes rows no caller reads).
//
// What bounds it on the H100: the bytes of out_b (4 x P*R x L floats a
// cell, 49 KB at c = 32) against about 16 SFU and 100 FP32 operations a
// pair inside the cutoff (~9 % of the tested pairs at water density).
//
// Design (the staging and the walk are window_walk.cuh's). A block owns a
// cell, 32 warps while cells are fewer than SMs, else 16. It stages the
// five columns' lanes (shifts added) as runs: run d * nzr + zr is z-run
// zr (the wrapper's run table: one species' slots of one z-cell, at most
// 32 lanes) of column d, cut at its last occupied lane and boxed. Two kinds
// of work unit share the warps in turn:
// - Row units, the own column (d = 0, about two thirds of the pairs, only
//   the center side): a real row against the column's runs of one lane
//   species; runs whose box lies beyond the cutoff are skipped, the rest
//   walked 64 lanes at a time and the pairs inside queued; four Gaussians
//   a thread, 32 / G pairs a step (G = R/4). Each unit's sums stay in
//   registers and are written once.
// - Lane units, the half offsets (d >= 1, both sides): a run's lanes (a
//   thread each) against the real rows of one species s_r whose box test
//   passes. Each row's pairs join the warp's queue; a step takes 32 / G
//   queued pairs, four Gaussians a thread, and leaves each pair's terms in
//   shared memory, from where each lane's own thread adds those of its
//   pairs (in queue order) to its registers: the unit owns its lanes'
//   out_b rows of species s_r and writes them once. The center sums of a
//   step are summed per row by a segmented scan in queue order and added
//   to the unit's partial rows.
// The block adds the partials in a fixed order at the end. The backward
// has the same units and one evaluation per pair: row units add each
// lane's cotangent into their warp's own plane, lane units keep it in the
// lane's thread; per-row center cotangents go through partials; the block
// sums the planes and partials in order. No atomics: both directions are
// bitwise repeatable.
//
// The decisions of the plain version are taken on its rounding: d2 < rc^2
// rounded op by op (the box test too), the self lane by index, the clamp
// of d2 at 1e-12 and min(r, rc) with r rounded as PyTorch's sqrt within
// 1e-6 of rc; the backward stops the gradient where those clamps do.
// Intrinsics: rsqrt.approx for 1/r and r, ex2.approx for the Gaussians,
// __cosf and __sinf (the SFU's) on [0, pi) for the cutoff.
#include <cuda_runtime.h>

#include <cstdint>

#include "window_walk.cuh"

namespace {

constexpr int kMaxSpecies = 8;
constexpr int kMaxRadial = 16;
constexpr int kMaxZRuns = 40;       // 5 columns x 40 runs <= walk::kMaxRuns
constexpr int kColumns = 5;         // the own column and the 4 half offsets
using walk::kFull;

struct PairParams {
  int ncells, nx, ny, nz, c, ll, npres, n_r, out_w, nzr;
  float rc, rc2, pi_rc, scale, r_near;
  int row_off[kMaxSpecies + 1];     // center rows of each species
  int self_shift[kMaxSpecies];      // self lane = row + self_shift[s]
  int zr_first[kMaxZRuns], zr_len[kMaxZRuns], zr_sp[kMaxZRuns];
  int zs_off[kMaxSpecies + 1];      // z-runs of species s: [zs_off[s], +1)
  float rs[kMaxRadial], nel2[kMaxRadial], m2eta[kMaxRadial];
  walk::RunTable runs;              // run d * nzr + zr
};

// The cell of column d of cell a: the xy half offset, same z.
__device__ __forceinline__ int column_cell(int a, int d, const PairParams& p) {
  // HALF_OFFSETS: (0,0), (1,0), (0,1), (1,1), (1,-1).
  const int ox = (d == 1 || d >= 3) ? 1 : 0;
  const int oy = (d == 2 || d == 3) ? 1 : (d == 4 ? -1 : 0);
  const int az = a % p.nz, axy = a / p.nz;
  const int ay = axy % p.ny, ax = axy / p.ny;
  const int bx = (ax + ox + p.nx) % p.nx, by = (ay + oy + p.ny) % p.ny;
  return (bx * p.ny + by) * p.nz + az;
}

// Units of a cell: lane units first (u < nlane: z-run zr, column d >= 1,
// row species s_r), then row units (real row ri, lane species s_l).
__host__ __device__ inline int lane_units(const PairParams& p) {
  return 4 * p.nzr * p.npres;
}

// Shared memory, as offsets from the dynamic __shared__ array: the stage,
// per warp a live-run table (64 ints), queue (96 ints) and scratch (the
// row units' pair terms, the lane units' step terms or cotangent rows);
// the centers, real rows, their count and per-species offsets; then
// - forward: the row units' sums [c][P][RP] and the lane units' partial
//   center sums [4 nzr][c][RP];
// - backward (whose lane units keep a step's pair cotangents in the
//   live-run table, or after the scratch at R <= 4): the
//   center cotangent rows [c][P*R], the row units' center
//   sums [c][P][3], the lane units' [4 nzr][c][3], the warps' planes of
//   the own column [nw][3][L] and the lane units' lane sums [nlane][3][32].
struct Layout {
  walk::StageLayout stage;
  size_t tbl, queue, scratch, ctr, srow, nreal, sroff;
  size_t rowsum, part, ga, planes, dzp, bytes;
  int scratch_floats;
};

__host__ __device__ inline Layout layout(const PairParams& p, int nw, int rp,
                                         bool bwd) {
  Layout o;
  size_t at = 0;
  o.stage = walk::stage_layout(at, kColumns * p.ll, p.runs.nruns, false);
  o.scratch_floats = bwd ? 32 * rp + (rp == 4 ? 96 : 0) : 128;
  o.tbl = walk::region(at, (size_t)256 * nw);
  o.queue = walk::region(at, (size_t)384 * nw);
  o.scratch = walk::region(at, (size_t)4 * o.scratch_floats * nw);
  o.ctr = walk::region(at, (size_t)16 * p.c);
  o.srow = walk::region(at, (size_t)4 * p.c);
  o.nreal = walk::region(at, 4);
  o.sroff = walk::region(at, 4 * (kMaxSpecies + 1));
  if (!bwd) {
    o.rowsum = walk::region(at, (size_t)4 * p.c * p.npres * rp);
    o.part = walk::region(at, (size_t)16 * p.nzr * p.c * rp);
    o.ga = o.planes = o.dzp = 0;
  } else {
    o.ga = walk::region(at, (size_t)4 * p.c * p.out_w);
    o.rowsum = walk::region(at, (size_t)12 * p.c * p.npres);
    o.part = walk::region(at, (size_t)48 * p.nzr * p.c);
    o.planes = walk::region(at, (size_t)12 * p.ll * nw);
    o.dzp = walk::region(at, (size_t)384 * lane_units(p));
  }
  o.bytes = at;
  return o;
}

// The block's rows in shared memory: the centers (x, y, z, and the self
// lane's index as the bits of w), the real rows in order, their count and
// the real rows' offsets per species.
struct Rows {
  float4* ctr;
  int* srow;
  int* nreal;
  int* sroff;
};

__device__ __forceinline__ Rows make_rows(unsigned char* smem,
                                          const Layout& o) {
  Rows r;
  r.ctr = reinterpret_cast<float4*>(smem + o.ctr);
  r.srow = reinterpret_cast<int*>(smem + o.srow);
  r.nreal = reinterpret_cast<int*>(smem + o.nreal);
  r.sroff = reinterpret_cast<int*>(smem + o.sroff);
  return r;
}

// Stages the five columns' lanes (z-triples, shifts added to the half
// offsets as the plain version adds them) and the cell's centers, lists
// the real rows and counts them per species.
__device__ __forceinline__ void stage(const float* __restrict__ ctr,
                                      const float* __restrict__ z3,
                                      const float* __restrict__ shift, int a,
                                      const PairParams& p,
                                      const walk::Stage& s, const Rows& rows) {
  const int ll = p.ll;
  walk::stage_window(
      p.runs, s, kColumns * ll,
      [&](int l) {
        const int d = l / ll, j = l - d * ll;
        const float* z = z3 + (size_t)column_cell(a, d, p) * 3 * ll + j;
        float4 v = make_float4(z[0], z[ll], z[2 * ll], 0.f);
        if (d > 0) {
          const float* sh = shift + ((size_t)a * 4 + d - 1) * 3;
          v.x = v.x + sh[0];
          v.y = v.y + sh[1];
          v.z = v.z + sh[2];
        }
        return v;
      },
      [](int) { return 0; },
      [&] {
        const size_t cbase = (size_t)a * p.c * 3;
        for (int r = threadIdx.x; r < p.c; r += blockDim.x) {
          int sp = 0;
          for (int k = 1; k < p.npres; ++k)
            if (r >= p.row_off[k]) sp = k;
          rows.ctr[r] = make_float4(ctr[cbase + 3 * r], ctr[cbase + 3 * r + 1],
                                    ctr[cbase + 3 * r + 2],
                                    __int_as_float(r + p.self_shift[sp]));
        }
      },
      [&] {
        walk::list_real_rows(rows.ctr, p.c, rows.srow, rows.nreal);
        const int lane = threadIdx.x & 31;
        for (int sp = 0; sp <= p.npres; ++sp) {
          int n = 0;
          for (int b = 0; b < p.row_off[sp]; b += 32) {
            const int r = b + lane;
            n += __popc(__ballot_sync(
                kFull, r < p.row_off[sp] && rows.ctr[r].x < walk::kEmpty));
          }
          if (lane == 0) rows.sroff[sp] = n;
        }
      });
}

// A lane unit's walk: run u's lanes (lane k of the warp holds lane k of the
// run) against the real rows rows.srow[r0 .. r1), in order. A row is
// tested only where the run's box lies inside its cutoff; its pairs join
// the warp's queue (entries row * 32 + lane) in lane order, and `step(qn)`
// takes the queue whenever it is full, then the rest. Bit k of a thread's
// `mine` says that queue entry k is its lane's (step clears it).
template <int PAIRS, class Step>
__device__ inline void lane_walk(const walk::Stage& s, const Rows& rows,
                                 int u, int r0, int r1, float rc2,
                                 int* queue, unsigned& mine, Step step) {
  const int lane = threadIdx.x & 31;
  const int n = s.len[u];
  if (n == 0) return;
  const float* b = s.box + 6 * u;
  const bool on = lane < n;
  const float4 v = on ? s.lane[s.start[u] + lane]
                      : make_float4(walk::kEmpty, 0.f, 0.f, 0.f);
  int qn = 0;
  for (int rb = r0; rb < r1; rb += 32) {
    const int ri = rb + lane;
    int row = 0;
    bool live = false;
    if (ri < r1) {
      row = rows.srow[ri];
      const float4 c = rows.ctr[row];
      live = walk::dist2_rn(walk::box_gap(c.x, b[0], b[3]),
                            walk::box_gap(c.y, b[1], b[4]),
                            walk::box_gap(c.z, b[2], b[5])) < rc2;
    }
    unsigned lm = __ballot_sync(kFull, live);
    while (lm) {
      const int t = __ffs(lm) - 1;
      lm &= lm - 1u;
      const int rw = __shfl_sync(kFull, row, t);
      float dx, dy, dz;
      const bool valid =
          on && walk::dist2_to(v, rows.ctr[rw], dx, dy, dz) < rc2;
      unsigned bal = __ballot_sync(kFull, valid);
      while (bal) {
        if (qn == PAIRS) {
          step(qn);
          qn = 0;
        }
        const int rank = __popc(bal & walk::lanemask_lt());
        const bool take = ((bal >> lane) & 1u) && rank < PAIRS - qn;
        const unsigned tk = __ballot_sync(kFull, take);
        if (take) {
          queue[qn + rank] = rw * 32 + lane;
          mine |= 1u << (qn + rank);
        }
        qn += __popc(tk);
        bal &= ~tk;
      }
    }
  }
  if (qn > 0) step(qn);
}

// Segmented inclusive sum of v over the step's pairs (pair k on lanes
// k*G .. k*G+G-1) in queue order, the segments being runs of one row;
// returns whether this thread's pair ends its row's segment.
template <int G, int PAIRS, int N>
__device__ __forceinline__ bool row_scan(float (&v)[N], int row, int k,
                                         int qn) {
#pragma unroll
  for (int off = 1; off < PAIRS; off <<= 1) {
    float up[N];
#pragma unroll
    for (int i = 0; i < N; ++i) up[i] = __shfl_up_sync(kFull, v[i], off * G);
    const int rr = __shfl_up_sync(kFull, row, off * G);
    if (k >= off && rr == row) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += up[i];
    }
  }
  const int next = __shfl_down_sync(kFull, row, G);
  return k < qn && (k == qn - 1 || next != row);
}

template <int RP>
__global__ void __launch_bounds__(walk::kMaxThreads)
pair_radial_fwd_kernel(const float* __restrict__ ctr,
                       const float* __restrict__ z3,
                       const float* __restrict__ shift,
                       float* __restrict__ out_a, float* __restrict__ out_b,
                       const PairParams p) {
  constexpr int G = RP / 4, PAIRS = 32 / G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = walk::warp_id(), lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const Layout o = layout(p, nw, RP, false);
  const walk::Stage s = walk::make_stage(smem, o.stage, false);
  int* tbl = reinterpret_cast<int*>(smem + o.tbl) + 64 * warp;
  int* queue = reinterpret_cast<int*>(smem + o.queue) + 96 * warp;
  float* scratch =
      reinterpret_cast<float*>(smem + o.scratch) + o.scratch_floats * warp;
  const Rows rows = make_rows(smem, o);
  float* rowsum = reinterpret_cast<float*>(smem + o.rowsum);
  float* part = reinterpret_cast<float*>(smem + o.part);
  const int a = blockIdx.x;
  for (int i = threadIdx.x; i < 4 * p.nzr * p.c * RP; i += blockDim.x)
    part[i] = 0.f;
  stage(ctr, z3, shift, a, p, s, rows);

  const int g = lane % G;
  float rsq[4], nel2q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rsq[i] = p.rs[4 * g + i];
    nel2q[i] = p.nel2[4 * g + i];
  }
  const int nlane = lane_units(p), nreal = *rows.nreal;
  for (int u = warp; u < nlane + p.npres * nreal; u += nw) {
    if (u < nlane) {
      // Lane unit: z-run zr of column d against the rows of species s_r.
      const int s_r = u % p.npres, dd = (u / p.npres) % 4,
                zr = u / (4 * p.npres);
      const int ru = (dd + 1) * p.nzr + zr;      // staged run
      const int start = s.start[ru];
      float* cp = part + (size_t)(dd * p.nzr + zr) * p.c * RP;
      float accb[RP];
#pragma unroll
      for (int q = 0; q < RP; ++q) accb[q] = 0.f;
      unsigned mine = 0u;
      lane_walk<PAIRS>(
          s, rows, ru, rows.sroff[s_r], rows.sroff[s_r + 1], p.rc2, queue,
          mine, [&](int qn) {
            __syncwarp();
            const int k = lane / G;
            const bool on = k < qn;
            const int e = on ? queue[k] : 0;
            const int row = on ? e >> 5 : -1;
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            if (on) {
              float dx, dy, dz, r, rinv;
              const float d2 = walk::dist2_to(s.lane[start + (e & 31)],
                                              rows.ctr[row], dx, dy, dz);
              walk::radius(d2, p.r_near, r, rinv);
              const float fc = fmaf(0.5f, __cosf(p.pi_rc * r), 0.5f);
              const float rm = fminf(r, p.rc);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float du = rm - rsq[i];
                t[i] = fc * walk::ex2(nel2q[i] * (du * du));
              }
            }
            reinterpret_cast<float4*>(scratch)[k * G + g] =
                make_float4(t[0], t[1], t[2], t[3]);
            if (row_scan<G, PAIRS>(t, row, k, qn)) {
              float* pr = cp + row * RP + 4 * g;
#pragma unroll
              for (int i = 0; i < 4; ++i) pr[i] += t[i];
            }
            __syncwarp();
            while (mine) {
              const float4* tr = reinterpret_cast<const float4*>(scratch) +
                                 (__ffs(mine) - 1) * G;
              mine &= mine - 1u;
#pragma unroll
              for (int j = 0; j < G; ++j) {
                const float4 x = tr[j];
                accb[4 * j] += x.x;
                accb[4 * j + 1] += x.y;
                accb[4 * j + 2] += x.z;
                accb[4 * j + 3] += x.w;
              }
            }
            __syncwarp();
          });
      if (lane < p.zr_len[zr]) {
        float* ob = out_b +
                    (((size_t)a * 4 + dd) * p.out_w + s_r * p.n_r) * p.ll +
                    p.zr_first[zr] + lane;
#pragma unroll
        for (int q = 0; q < RP; ++q)
          if (q < p.n_r) ob[(size_t)q * p.ll] = p.scale * accb[q];
      }
    } else {
      // Row unit: a real row against the own column's runs of species s_l.
      const int v = u - nlane, s_l = v % p.npres, row = rows.srow[v / p.npres];
      const float4 c = rows.ctr[row];
      const int z0 = p.zs_off[s_l], nk = p.zs_off[s_l + 1] - z0;
      const walk::LiveRuns L =
          walk::live_runs(s, z0, 1, nk, c.x, c.y, c.z, p.rc2, tbl);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float2* qd = reinterpret_cast<float2*>(scratch);
      walk::walk(
          L, queue, [&](int pos) { return walk::pairs_with(s, pos, c, p.rc2); },
          [&](int pos, bool on) {
            float rm = 0.f, fc = 0.f;
            if (on) {
              float dx, dy, dz, r, rinv;
              walk::radius(walk::dist2_to(s.lane[pos], c, dx, dy, dz),
                           p.r_near, r, rinv);
              fc = fmaf(0.5f, __cosf(p.pi_rc * r), 0.5f);
              rm = fminf(r, p.rc);
            }
            qd[lane] = make_float2(rm, fc);
            __syncwarp();
            const int n = __popc(__ballot_sync(kFull, on));
            for (int i = 0; i < n; i += PAIRS) {
              const float2 e = qd[i + lane / G];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float du = e.x - rsq[k];
                acc[k] = fmaf(e.y, walk::ex2(nel2q[k] * (du * du)), acc[k]);
              }
            }
            __syncwarp();
          });
#pragma unroll
      for (int k = 0; k < 4; ++k)
        for (int off = G; off < 32; off <<= 1)
          acc[k] += __shfl_xor_sync(kFull, acc[k], off);
      if (lane < G) {
        float* rs_ = rowsum + ((size_t)row * p.npres + s_l) * RP + 4 * lane;
#pragma unroll
        for (int k = 0; k < 4; ++k) rs_[k] = acc[k];
      }
    }
  }
  __syncthreads();

  // out_a: the own column's sums, then the half offsets' partials of the
  // lane species' runs, column by column.
  for (int i = threadIdx.x; i < p.c * p.out_w; i += blockDim.x) {
    const int row = i / p.out_w, col = i - row * p.out_w;
    const int sp = col / p.n_r, q = col - sp * p.n_r;
    float v = 0.f;
    if (rows.ctr[row].x < walk::kEmpty) {
      v = rowsum[((size_t)row * p.npres + sp) * RP + q];
      for (int zr = p.zs_off[sp]; zr < p.zs_off[sp + 1]; ++zr)
        for (int dd = 0; dd < 4; ++dd)
          v += part[((size_t)(dd * p.nzr + zr) * p.c + row) * RP + q];
    }
    out_a[(size_t)a * p.c * p.out_w + i] = p.scale * v;
  }
}

template <int RP>
__global__ void __launch_bounds__(walk::kMaxThreads)
pair_radial_bwd_kernel(const float* __restrict__ ctr,
                       const float* __restrict__ z3,
                       const float* __restrict__ shift,
                       const float* __restrict__ ga,
                       const float* __restrict__ gb,
                       float* __restrict__ dctr, float* __restrict__ dz5,
                       float* __restrict__ dsh, const PairParams p) {
  constexpr int G = RP / 4, PAIRS = 32 / G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = walk::warp_id(), lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const Layout o = layout(p, nw, RP, true);
  const walk::Stage s = walk::make_stage(smem, o.stage, false);
  int* tbl = reinterpret_cast<int*>(smem + o.tbl) + 64 * warp;
  int* queue = reinterpret_cast<int*>(smem + o.queue) + 96 * warp;
  float* scratch =
      reinterpret_cast<float*>(smem + o.scratch) + o.scratch_floats * warp;
  const Rows rows = make_rows(smem, o);
  float* gas = reinterpret_cast<float*>(smem + o.ga);
  float* rowsum = reinterpret_cast<float*>(smem + o.rowsum);
  float* part = reinterpret_cast<float*>(smem + o.part);
  float* planes = reinterpret_cast<float*>(smem + o.planes);
  float* dzp = reinterpret_cast<float*>(smem + o.dzp);
  const int a = blockIdx.x;
  const int ll = p.ll;
  for (int i = threadIdx.x; i < p.c * p.out_w; i += blockDim.x)
    gas[i] = ga[(size_t)a * p.c * p.out_w + i];
  for (int i = threadIdx.x; i < 12 * p.nzr * p.c; i += blockDim.x)
    part[i] = 0.f;
  for (int i = threadIdx.x; i < 3 * ll * nw; i += blockDim.x) planes[i] = 0.f;
  stage(ctr, z3, shift, a, p, s, rows);

  const int g = lane % G;
  float rsq[4], nel2q[4], m2q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rsq[i] = p.rs[4 * g + i];
    nel2q[i] = p.nel2[4 * g + i];
    m2q[i] = p.m2eta[4 * g + i];
  }
  const int nlane = lane_units(p), nreal = *rows.nreal;
  for (int u = warp; u < nlane + p.npres * nreal; u += nw) {
    if (u < nlane) {
      // Lane unit: the lane's cotangent stays in its thread; the rows'
      // go through the unit's partial rows by a segmented scan.
      const int s_r = u % p.npres, dd = (u / p.npres) % 4,
                zr = u / (4 * p.npres);
      const int ru = (dd + 1) * p.nzr + zr;
      const int start = s.start[ru], sp_l = p.zr_sp[zr];
      float* cp = part + (size_t)(dd * p.nzr + zr) * p.c * 3;
      float* gbr = scratch;                        // [RP][32]
      // A step's pair cotangents [PAIRS][3]: in the live-run table, which
      // only row units use, where they fit.
      float* tb = 3 * PAIRS <= 64 ? reinterpret_cast<float*>(tbl)
                                  : scratch + 32 * RP;
      {
        const float* gbs =
            gb + (((size_t)a * 4 + dd) * p.out_w + s_r * p.n_r) * ll +
            p.zr_first[zr] + lane;
        const bool in = lane < p.zr_len[zr];
#pragma unroll
        for (int q = 0; q < RP; ++q)
          gbr[q * 32 + lane] = (in && q < p.n_r) ? gbs[(size_t)q * ll] : 0.f;
      }
      __syncwarp();
      float lx = 0.f, ly = 0.f, lz = 0.f;
      unsigned mine = 0u;
      lane_walk<PAIRS>(
          s, rows, ru, rows.sroff[s_r], rows.sroff[s_r + 1], p.rc2, queue,
          mine, [&](int qn) {
            __syncwarp();
            const int k = lane / G;
            const bool on = k < qn;
            const int e = on ? queue[k] : 0;
            const int row = on ? e >> 5 : -1, lj = e & 31;
            float dx = 0.f, dy = 0.f, dz = 0.f, fc = 0.f, dfc = 0.f,
                  rinv_c = 0.f, rinv_m = 0.f, ac = 0.f, bc = 0.f;
            if (on) {
              float r, rinv;
              const float d2 = walk::dist2_to(s.lane[start + lj],
                                              rows.ctr[row], dx, dy, dz);
              walk::radius(d2, p.r_near, r, rinv);
              const float x = p.pi_rc * r;
              fc = fmaf(0.5f, __cosf(x), 0.5f);
              dfc = -0.5f * p.pi_rc * __sinf(x);
              rinv_c = d2 >= 1e-12f ? rinv : 0.f;
              rinv_m = d2 >= 1e-12f && r <= p.rc ? rinv : 0.f;
              const float rm = fminf(r, p.rc);
              const float* gar = gas + row * p.out_w + sp_l * p.n_r;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int q = 4 * g + i;
                if (q < p.n_r) {
                  const float du = rm - rsq[i];
                  const float ge = (gar[q] + gbr[q * 32 + lj]) *
                                   walk::ex2(nel2q[i] * (du * du));
                  ac += ge;
                  bc = fmaf(ge * m2q[i], du, bc);
                }
              }
            }
#pragma unroll
            for (int off = 1; off < G; off <<= 1) {
              ac += __shfl_xor_sync(kFull, ac, off);
              bc += __shfl_xor_sync(kFull, bc, off);
            }
            const float coef = p.scale * (ac * dfc * rinv_c + fc * bc * rinv_m);
            float gv[3] = {coef * dx, coef * dy, coef * dz};
            if (g == 0) {
              tb[3 * k] = gv[0];
              tb[3 * k + 1] = gv[1];
              tb[3 * k + 2] = gv[2];
            }
            if (row_scan<G, PAIRS>(gv, row, k, qn) && g == 0) {
              float* pr = cp + row * 3;
              pr[0] += gv[0];
              pr[1] += gv[1];
              pr[2] += gv[2];
            }
            __syncwarp();
            while (mine) {
              const float* o = tb + 3 * (__ffs(mine) - 1);
              mine &= mine - 1u;
              lx += o[0];
              ly += o[1];
              lz += o[2];
            }
            __syncwarp();
          });
      float* dp = dzp + (size_t)u * 96 + lane;
      dp[0] = lx;
      dp[32] = ly;
      dp[64] = lz;
    } else {
      // Row unit: each lane's cotangent goes into this warp's plane.
      const int v = u - nlane, s_l = v % p.npres, row = rows.srow[v / p.npres];
      const float4 c = rows.ctr[row];
      float gq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * g + i;
        gq[i] = q < p.n_r ? gas[row * p.out_w + s_l * p.n_r + q] : 0.f;
      }
      const int z0 = p.zs_off[s_l], nk = p.zs_off[s_l + 1] - z0;
      const walk::LiveRuns L =
          walk::live_runs(s, z0, 1, nk, c.x, c.y, c.z, p.rc2, tbl);
      float* pl = planes + (size_t)warp * 3 * ll;
      float* qd = scratch;
      float ax = 0.f, ay = 0.f, az = 0.f;
      walk::walk(
          L, queue, [&](int pos) { return walk::pairs_with(s, pos, c, p.rc2); },
          [&](int pos, bool on) {
            float dx = 0.f, dy = 0.f, dz = 0.f, rm = 0.f, fc = 0.f, dfc = 0.f,
                  rinv_c = 0.f, rinv_m = 0.f;
            if (on) {
              float r, rinv;
              const float d2 = walk::dist2_to(s.lane[pos], c, dx, dy, dz);
              walk::radius(d2, p.r_near, r, rinv);
              const float x = p.pi_rc * r;
              fc = fmaf(0.5f, __cosf(x), 0.5f);
              dfc = -0.5f * p.pi_rc * __sinf(x);
              rinv_c = d2 >= 1e-12f ? rinv : 0.f;
              rinv_m = d2 >= 1e-12f && r <= p.rc ? rinv : 0.f;
              rm = fminf(r, p.rc);
            }
            qd[lane] = rm;
            __syncwarp();
            const int n = __popc(__ballot_sync(kFull, on));
            float a_own = 0.f, b_own = 0.f;
            for (int i = 0; i < n; i += PAIRS) {
              const float rmk = qd[i + lane / G];
              float ac = 0.f, bc = 0.f;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float du = rmk - rsq[k];
                const float ge = gq[k] * walk::ex2(nel2q[k] * (du * du));
                ac += ge;
                bc = fmaf(ge * m2q[k], du, bc);
              }
#pragma unroll
              for (int off = 1; off < G; off <<= 1) {
                ac += __shfl_xor_sync(kFull, ac, off);
                bc += __shfl_xor_sync(kFull, bc, off);
              }
              const bool mine = lane >= i && lane < i + PAIRS;
              const int src = mine ? G * (lane - i) : 0;
              const float av = __shfl_sync(kFull, ac, src),
                          bv = __shfl_sync(kFull, bc, src);
              if (mine) {
                a_own = av;
                b_own = bv;
              }
            }
            __syncwarp();
            if (on) {
              const float coef =
                  p.scale * (a_own * dfc * rinv_c + fc * b_own * rinv_m);
              const float gx = coef * dx, gy = coef * dy, gz = coef * dz;
              pl[pos] += gx;
              pl[ll + pos] += gy;
              pl[2 * ll + pos] += gz;
              ax += gx;
              ay += gy;
              az += gz;
            }
          });
      ax = walk::warp_sum(ax);
      ay = walk::warp_sum(ay);
      az = walk::warp_sum(az);
      if (lane == 0) {
        float* rs_ = rowsum + ((size_t)row * p.npres + s_l) * 3;
        rs_[0] = ax;
        rs_[1] = ay;
        rs_[2] = az;
      }
    }
  }
  __syncthreads();

  // The own column: the warps' planes in warp order.
  const size_t plane = (size_t)p.ncells * 3 * ll;
  for (int i = threadIdx.x; i < 3 * ll; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += planes[(size_t)w * 3 * ll + i];
    dz5[(size_t)a * 3 * ll + i] = v;
  }
  // The half offsets: each lane's sums over the row species in order, and
  // per column their sum over the lanes (the shift's cotangent) by a warp.
  for (int i = threadIdx.x; i < 4 * 3 * ll; i += blockDim.x) {
    const int dd = i / (3 * ll), rem = i - dd * 3 * ll;
    const int comp = rem / ll, l = rem - comp * ll;
    int zr = 0;
    while (zr + 1 < p.nzr && p.zr_first[zr + 1] <= l) ++zr;
    const int j = l - p.zr_first[zr];
    float v = 0.f;
    for (int sr = 0; sr < p.npres; ++sr)
      v += dzp[(size_t)((zr * 4 + dd) * p.npres + sr) * 96 + comp * 32 + j];
    dz5[(dd + 1) * plane + (size_t)column_cell(a, dd + 1, p) * 3 * ll +
        rem] = v;
  }
  for (int t = warp; t < 12; t += nw) {
    const int dd = t / 3, comp = t - dd * 3;
    float v = 0.f;
    for (int zr = 0; zr < p.nzr; ++zr)
      if (lane < p.zr_len[zr])
        for (int sr = 0; sr < p.npres; ++sr)
          v += dzp[(size_t)((zr * 4 + dd) * p.npres + sr) * 96 + comp * 32 +
                   lane];
    v = walk::warp_sum(v);
    if (lane == 0) dsh[((size_t)a * 4 + dd) * 3 + comp] = v;
  }
  for (int row = threadIdx.x; row < p.c; row += blockDim.x) {
    float vx = 0.f, vy = 0.f, vz = 0.f;
    if (rows.ctr[row].x < walk::kEmpty) {
      for (int sp = 0; sp < p.npres; ++sp) {
        const float* r3 = rowsum + ((size_t)row * p.npres + sp) * 3;
        vx -= r3[0];
        vy -= r3[1];
        vz -= r3[2];
      }
      for (int k = 0; k < 4 * p.nzr; ++k) {
        const float* r3 = part + ((size_t)k * p.c + row) * 3;
        vx -= r3[0];
        vy -= r3[1];
        vz -= r3[2];
      }
    }
    const size_t crow = (size_t)a * p.c + row;
    dctr[crow * 3] = vx;
    dctr[crow * 3 + 1] = vy;
    dctr[crow * 3 + 2] = vz;
  }
}

// The row and lane geometry comes from the wrapper (PairGeometry and
// pair_runs in cuda_zpair.py, which the plain version follows too); it is
// checked here: rows tile [0, c) by species, the z-runs tile [0, 3c) in
// order, species-major, at most 32 lanes each and inside their species'
// lane block, and each species' runs of the middle z-cell hold its rows'
// self lanes.
int make_params(PairParams& p, int nx, int ny, int nz, int npres,
                const int* row_off, int nzr, const int* zr_first,
                const int* zr_len, const int* zr_sp, int n_r,
                const float* eta, const float* rs, double rc, double scale) {
  if (nx < 3 || ny < 3 || nz < 3 || npres < 1 || npres > kMaxSpecies ||
      n_r < 1 || n_r > kMaxRadial || nzr < 1 || nzr > kMaxZRuns ||
      row_off[0] != 0)
    return (int)cudaErrorInvalidValue;
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  p.ncells = nx * ny * nz;
  p.npres = npres;
  p.c = row_off[npres];
  p.ll = 3 * p.c;
  p.n_r = n_r;
  p.out_w = npres * n_r;
  p.nzr = nzr;
  p.rc = (float)rc;
  p.rc2 = (float)(rc * rc);
  p.pi_rc = (float)(3.14159265358979323846 / rc);
  p.r_near = (float)(rc * (1.0 - 1e-6));
  p.scale = (float)scale;
  for (int sp = 0; sp <= kMaxSpecies; ++sp)
    p.row_off[sp] = sp <= npres ? row_off[sp] : p.c;
  for (int sp = 0; sp < kMaxSpecies; ++sp) {
    const int cs = sp < npres ? row_off[sp + 1] - row_off[sp] : 0;
    if (cs < 0) return (int)cudaErrorInvalidValue;
    p.self_shift[sp] = sp < npres ? 2 * row_off[sp] + cs : 0;
  }
  int next = 0;
  for (int zr = 0; zr < kMaxZRuns; ++zr) {
    const bool on = zr < nzr;
    p.zr_first[zr] = on ? zr_first[zr] : p.ll;
    p.zr_len[zr] = on ? zr_len[zr] : 0;
    p.zr_sp[zr] = on ? zr_sp[zr] : 0;
    if (!on) continue;
    const int sp = zr_sp[zr];
    if (sp < 0 || sp >= npres || (zr > 0 && sp < zr_sp[zr - 1]) ||
        zr_first[zr] != next || zr_len[zr] < 1 || zr_len[zr] > 32 ||
        zr_first[zr] < 3 * row_off[sp] ||
        zr_first[zr] + zr_len[zr] > 3 * row_off[sp + 1])
      return (int)cudaErrorInvalidValue;
    next += zr_len[zr];
  }
  for (int sp = 0; sp <= kMaxSpecies; ++sp) {
    int n = 0;
    while (n < nzr && zr_sp[n] < sp) ++n;
    p.zs_off[sp] = n;
  }
  if (next != p.ll) return (int)cudaErrorInvalidValue;
  // Every row's self lane lies in a run of its own species' middle third.
  for (int sp = 0; sp < npres; ++sp) {
    const int cs = row_off[sp + 1] - row_off[sp];
    if (cs == 0) continue;
    if (p.zs_off[sp + 1] - p.zs_off[sp] > 32 ||
        p.zr_first[p.zs_off[sp]] != 3 * row_off[sp])
      return (int)cudaErrorInvalidValue;
  }
  p.runs.nruns = kColumns * nzr;
  for (int d = 0; d < kColumns; ++d)
    for (int zr = 0; zr < nzr; ++zr) {
      p.runs.first[d * nzr + zr] = d * p.ll + zr_first[zr];
      p.runs.len[d * nzr + zr] = zr_len[zr];
    }
  for (int i = 0; i < kMaxRadial; ++i) {
    const bool on = i < n_r;
    p.rs[i] = on ? rs[i] : 0.f;
    p.nel2[i] = on ? (float)(-(double)eta[i] * 1.4426950408889634) : 0.f;
    p.m2eta[i] = on ? -2.f * eta[i] : 0.f;
  }
  return 0;
}

// The radial functions padded to a power of two (4 at least).
int radial_pad(int n_r) {
  int rp = 4;
  while (rp < n_r) rp <<= 1;
  return rp;
}

// Warps a block: window_walk's choice, fewer while the layout does not fit.
int pick_warps(const PairParams& p, int rp, bool bwd, size_t& smem) {
  for (int nw = walk::block_warps(p.ncells); nw >= 4; nw >>= 1) {
    smem = layout(p, nw, rp, bwd).bytes;
    if (smem <= (size_t)walk::kSmemLimit) return nw;
  }
  return 0;
}

template <int RP>
cudaError_t launch_fwd(const float* ctr, const float* z3, const float* shift,
                       float* out_a, float* out_b, const PairParams& p,
                       cudaStream_t stream) {
  size_t smem = 0;
  const int nw = pick_warps(p, RP, false, smem);
  if (nw == 0) return cudaErrorInvalidValue;
  cudaError_t err = walk::prepare(pair_radial_fwd_kernel<RP>, smem);
  if (err != cudaSuccess) return err;
  pair_radial_fwd_kernel<RP><<<p.ncells, 32 * nw, smem, stream>>>(
      ctr, z3, shift, out_a, out_b, p);
  return cudaGetLastError();
}

template <int RP>
cudaError_t launch_bwd(const float* ctr, const float* z3, const float* shift,
                       const float* ga, const float* gb, float* dctr,
                       float* dz5, float* dsh, const PairParams& p,
                       cudaStream_t stream) {
  size_t smem = 0;
  const int nw = pick_warps(p, RP, true, smem);
  if (nw == 0) return cudaErrorInvalidValue;
  cudaError_t err = walk::prepare(pair_radial_bwd_kernel<RP>, smem);
  if (err != cudaSuccess) return err;
  pair_radial_bwd_kernel<RP><<<p.ncells, 32 * nw, smem, stream>>>(
      ctr, z3, shift, ga, gb, dctr, dz5, dsh, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pair_radial_fwd(const float* ctr, const float* z3, const float* shift,
                    float* out_a, float* out_b, int nx, int ny, int nz,
                    int npres, const int* row_off, int nzr,
                    const int* zr_first, const int* zr_len, const int* zr_sp,
                    int n_r, const float* eta, const float* rs, double rc,
                    double scale, void* stream) {
  PairParams p;
  const int bad = make_params(p, nx, ny, nz, npres, row_off, nzr, zr_first,
                              zr_len, zr_sp, n_r, eta, rs, rc, scale);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (radial_pad(n_r)) {
    case 4: return (int)launch_fwd<4>(ctr, z3, shift, out_a, out_b, p, st);
    case 8: return (int)launch_fwd<8>(ctr, z3, shift, out_a, out_b, p, st);
    default: return (int)launch_fwd<16>(ctr, z3, shift, out_a, out_b, p, st);
  }
}

int pair_radial_bwd(const float* ctr, const float* z3, const float* shift,
                    const float* ga, const float* gb, float* dctr, float* dz5,
                    float* dsh, int nx, int ny, int nz, int npres,
                    const int* row_off, int nzr, const int* zr_first,
                    const int* zr_len, const int* zr_sp, int n_r,
                    const float* eta, const float* rs, double rc,
                    double scale, void* stream) {
  PairParams p;
  const int bad = make_params(p, nx, ny, nz, npres, row_off, nzr, zr_first,
                              zr_len, zr_sp, n_r, eta, rs, rc, scale);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (radial_pad(n_r)) {
    case 4:
      return (int)launch_bwd<4>(ctr, z3, shift, ga, gb, dctr, dz5, dsh, p, st);
    case 8:
      return (int)launch_bwd<8>(ctr, z3, shift, ga, gb, dctr, dz5, dsh, p, st);
    default:
      return (int)launch_bwd<16>(ctr, z3, shift, ga, gb, dctr, dz5, dsh, p,
                                 st);
  }
}

}  // extern "C"
