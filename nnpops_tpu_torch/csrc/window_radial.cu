// Window radial AEV, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_window.py:155
// make_window_radial_kernel: fwd_kernel (pallas_call at :361) and
// bwd_kernel (:378), with fc_impl='poly' and center_caps (cell-occupancy
// bucketing). Wrapper, autograd Function, plain PyTorch version and the
// run table: nnpops_tpu_torch/ops/cuda_window.py (its docstring states the
// contract).
//
// What bounds it on the H100: FP32 and SFU operations. Every (center,
// candidate lane) pair costs a distance test; a pair inside the cutoff
// (~7 % of the window's lanes at water density) costs an rsqrt, the
// degree-8 fc polynomial and R = 16 Gaussians (one ex2 each), and the
// backward adds two cotangent sums per Gaussian and the chain to the
// deltas. The bytes are small: the cell's 27-cell window (3 x kk floats,
// 10 KB at kk = 864) and its centers in, c_ctr x P*R floats out.
//
// Design (the walk is window_walk.cuh's): one block per cell, 32 warps
// while cells are fewer than SMs, else 16. The block stages the window,
// cuts each run (one species block of one stencil entry) at its last
// occupied lane and boxes it, and stages the cell's centers with their
// self lanes. A unit is a real center row against one group of runs; it
// skips the runs whose box lies beyond the cutoff, tests the rest 64 lanes
// at a time and queues the pairs inside the cutoff.
// - Forward: a unit is (species block, real row), the units go to the
//   warps in turn, species-major. Each queued pair's r and fc are one
//   thread's; its R Gaussians are then G = R/4 threads' (four each), 32/G
//   pairs a step, summed per thread and finally over the warp in a fixed
//   order; each output is written once.
// - Backward, no float atomics: a unit is (real row, run group j: one of
//   NL = P * NP parts of the species blocks, NP the fewest that make 4
//   groups and whose planes fit, two blocks an SM when cells outnumber
//   SMs). Warp (i, j) takes group j of real rows i, i + NR, ...; each
//   queued pair is one thread's, which evaluates its R Gaussians and adds
//   the candidate's cotangent into row group i's shared-memory plane at
//   the lane: within one row a lane appears once, and only warp (i, j)
//   writes group j's lanes of plane i. The block then sums the NR planes
//   per lane in order, and the NL partial center sums per row in order,
//   and writes every output once (empty lanes 0).
// Every sum runs in a fixed order: both directions are bitwise repeatable.
//
// The decisions of the plain version are taken on the values it rounds:
// d2 < rc^2 and t = min(d2/rc^2, 1) rounded op by op as PyTorch rounds
// them, the self lane by index, the sqrt's clamp of d2 at 1e-12, and
// min(r, rc) with r rounded as PyTorch's sqrt wherever the approximate r
// lies within 1e-6 of rc. The backward stops the gradient where those
// clamps do. Intrinsics (inline PTX, flush to zero): rsqrt.approx for
// 1/r and r, ex2.approx for the Gaussians. Centers at or beyond FAR/2 are
// empty slots: their rows are 0 and evaluate no pair.
#include <cuda_runtime.h>

#include <cstdint>

#include "window_walk.cuh"

namespace {

constexpr int kMaxSpecies = 8;
constexpr int kMaxRadial = 32;
using walk::kEntries;

struct WinParams {
  int ncells, kk, c_ctr, npres, n_r, out_w, npart;
  float rc, rc2, inv_rc2, two_inv_rc2, scale, r_near;
  int ctr_off[kMaxSpecies + 1];                    // packed center rows
  int self_shift[kMaxSpecies];   // self lane = row + self_shift[species]
  float rs[kMaxRadial], nel2[kMaxRadial], m2eta[kMaxRadial];
  walk::RunTable runs;           // run s * 27 + e: species s, entry e
};

// fc(t), t = (r/rc)^2: Horner chain of the degree-8 fit (FC_COEFFS in
// nnpops_tpu_torch/ops/cuda_aev.py).
__device__ __forceinline__ float fc_poly_t(float t) {
  float p = 1.8597632061664595e-06f;
  p = p * t + -5.1784521003695567e-05f;
  p = p * t + 0.00096425294148109802f;
  p = p * t + -0.012903133084020298f;
  p = p * t + 0.11766520747089387f;
  p = p * t + -0.66763136355346187f;
  p = p * t + 2.0293560611802657f;
  p = p * t + -2.4674011001964282f;
  p = p * t + 0.99999999999953115f;
  return p;
}

// d fc / dt: coefficient k of the derivative is FC_COEFFS[k] * k.
__device__ __forceinline__ float dfc_poly_t(float t) {
  float p = (float)(1.8597632061664595e-06 * 8);
  p = p * t + (float)(-5.1784521003695567e-05 * 7);
  p = p * t + (float)(0.00096425294148109802 * 6);
  p = p * t + (float)(-0.012903133084020298 * 5);
  p = p * t + (float)(0.11766520747089387 * 4);
  p = p * t + (float)(-0.66763136355346187 * 3);
  p = p * t + (float)(2.0293560611802657 * 2);
  p = p * t + (float)(-2.4674011001964282 * 1);
  return p;
}

__device__ __forceinline__ int self_lane_of(int row, const WinParams& p) {
  int s_row = 0;
  for (int s = 1; s < p.npres; ++s)
    if (row >= p.ctr_off[s]) s_row = s;
  return row + p.self_shift[s_row];
}

// Shared memory of a kernel, as offsets from the dynamic __shared__ array:
// the stage, per warp a live-run table (64 ints) and queue (96 ints), the
// centers, the real rows and their count; then the forward's per-warp
// batch of pair terms (32 float2), or the backward's cotangent rows
// [c_ctr][out_w], partial center sums [c_ctr][NL][3] and NR planes
// [NR][3][kk].
struct Layout {
  walk::StageLayout stage;
  size_t tbl, queue, ctr, srow, nreal, qd, sg, part, planes, bytes;
};

__host__ __device__ inline Layout layout(const WinParams& p, int nw,
                                         bool bwd) {
  Layout o;
  size_t at = 0;
  o.stage = walk::stage_layout(at, p.kk, p.runs.nruns, false);
  o.tbl = walk::region(at, (size_t)256 * nw);
  o.queue = walk::region(at, (size_t)384 * nw);
  o.ctr = walk::region(at, (size_t)16 * p.c_ctr);
  o.srow = walk::region(at, (size_t)4 * p.c_ctr);
  o.nreal = walk::region(at, 4);
  if (!bwd) {
    o.qd = walk::region(at, (size_t)256 * nw);
    o.sg = o.part = o.planes = 0;
  } else {
    o.qd = 0;
    const int nl = p.npres * p.npart, nr = nw / nl;
    o.sg = walk::region(at, (size_t)4 * p.c_ctr * p.out_w);
    o.part = walk::region(at, (size_t)12 * p.c_ctr * nl);
    o.planes = walk::region(at, (size_t)12 * p.kk * nr);
  }
  o.bytes = at;
  return o;
}

// The block's rows in shared memory: the centers (x, y, z, and the self
// lane's index as the bits of w) and the real rows.
struct Rows {
  float4* ctr;   // [c_ctr]
  int* srow;     // [c_ctr] the real rows in order
  int* nreal;
};

__device__ __forceinline__ Rows make_rows(unsigned char* smem,
                                          const Layout& o) {
  Rows r;
  r.ctr = reinterpret_cast<float4*>(smem + o.ctr);
  r.srow = reinterpret_cast<int*>(smem + o.srow);
  r.nreal = reinterpret_cast<int*>(smem + o.nreal);
  return r;
}

// Stages the window and the cell's centers, and lists the real rows.
__device__ __forceinline__ void stage(const float* __restrict__ cx,
                                      const float* __restrict__ cy,
                                      const float* __restrict__ cz,
                                      const float* __restrict__ centers,
                                      int cell, const WinParams& p,
                                      const walk::Stage& s,
                                      const Rows& rows) {
  const size_t base = (size_t)cell * p.kk;
  const size_t cbase = (size_t)cell * p.c_ctr * 3;
  walk::stage_window(
      p.runs, s, p.kk,
      [&](int l) {
        return make_float4(cx[base + l], cy[base + l], cz[base + l], 0.f);
      },
      [](int) { return 0; },
      [&] {
        for (int r = threadIdx.x; r < p.c_ctr; r += blockDim.x)
          rows.ctr[r] = make_float4(centers[cbase + 3 * r],
                                    centers[cbase + 3 * r + 1],
                                    centers[cbase + 3 * r + 2],
                                    __int_as_float(self_lane_of(r, p)));
      },
      [&] { walk::list_real_rows(rows.ctr, p.c_ctr, rows.srow, rows.nreal); });
}

template <int RP>
__global__ void __launch_bounds__(walk::kMaxThreads)
window_radial_fwd_kernel(const float* __restrict__ cx,
                         const float* __restrict__ cy,
                         const float* __restrict__ cz,
                         const float* __restrict__ centers,
                         float* __restrict__ out, const WinParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = walk::warp_id(), lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const Layout o = layout(p, nw, false);
  const walk::Stage s = walk::make_stage(smem, o.stage, false);
  int* tbl = reinterpret_cast<int*>(smem + o.tbl) + 64 * warp;
  int* queue = reinterpret_cast<int*>(smem + o.queue) + 96 * warp;
  const Rows rows = make_rows(smem, o);
  const int cell = blockIdx.x;
  stage(cx, cy, cz, centers, cell, p, s, rows);
  const size_t obase = (size_t)cell * p.c_ctr * p.out_w;
  for (int k = threadIdx.x; k < p.c_ctr * p.out_w; k += blockDim.x)
    if (rows.ctr[k / p.out_w].x >= walk::kEmpty) out[obase + k] = 0.f;

  // Units (species block, real row), a warp each in turn, species-major
  // so that a warp's second unit is of another species than its first.
  // Four radial functions a thread: a batch's pairs go G = RP / 4 threads
  // each, 32 / G pairs a step.
  constexpr int G = RP / 4;
  float rsq[4], nel2q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rsq[k] = p.rs[4 * (lane % G) + k];
    nel2q[k] = p.nel2[4 * (lane % G) + k];
  }
  float2* qd = reinterpret_cast<float2*>(smem + o.qd) + 32 * warp;
  const int nreal = *rows.nreal;
  int sp = 0, ri = warp;
  while (nreal > 0 && ri >= nreal) {
    ri -= nreal;
    ++sp;
  }
  while (nreal > 0 && sp < p.npres) {
    const int row = rows.srow[ri];
    const float4 c = rows.ctr[row];
    const walk::LiveRuns L = walk::live_runs(s, kEntries * sp, 1, kEntries,
                                             c.x, c.y, c.z, p.rc2, tbl);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    walk::walk(
        L, queue, [&](int pos) { return walk::pairs_with(s, pos, c, p.rc2); },
        [&](int pos, bool on) {
          // This thread's pair: r clamped to rc and fc (0 without one).
          float rm = 0.f, fc = 0.f;
          if (on) {
            const float4 v = s.lane[pos];
            const float d2 = walk::dist2_rn(__fsub_rn(v.x, c.x),
                                            __fsub_rn(v.y, c.y),
                                            __fsub_rn(v.z, c.z));
            float r, rinv;
            walk::radius(d2, p.r_near, r, rinv);
            fc = fc_poly_t(fminf(__fmul_rn(d2, p.inv_rc2), 1.f));
            rm = fminf(r, p.rc);
          }
          qd[lane] = make_float2(rm, fc);
          __syncwarp();
          const int n = __popc(__ballot_sync(walk::kFull, on));
          for (int i = 0; i < n; i += 32 / G) {
            const float2 e = qd[i + lane / G];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float u = e.x - rsq[k];
              acc[k] = fmaf(e.y, walk::ex2(nel2q[k] * (u * u)), acc[k]);
            }
          }
          __syncwarp();
        });
#pragma unroll
    for (int k = 0; k < 4; ++k)
      for (int off = G; off < 32; off <<= 1)
        acc[k] += __shfl_xor_sync(walk::kFull, acc[k], off);
    if (lane < G) {
      float* orow = out + obase + row * p.out_w + sp * p.n_r;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * lane + k < p.n_r) orow[4 * lane + k] = p.scale * acc[k];
    }
    ri += nw;
    while (ri >= nreal) {
      ri -= nreal;
      ++sp;
    }
  }
}

template <int RP>
__global__ void __launch_bounds__(walk::kMaxThreads)
window_radial_bwd_kernel(const float* __restrict__ cx,
                         const float* __restrict__ cy,
                         const float* __restrict__ cz,
                         const float* __restrict__ centers,
                         const float* __restrict__ g,
                         float* __restrict__ dcand,
                         float* __restrict__ dctr, const WinParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = walk::warp_id(), lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int nl = p.npres * p.npart, nr = nw / nl;
  const Layout o = layout(p, nw, true);
  const walk::Stage s = walk::make_stage(smem, o.stage, false);
  int* tbl = reinterpret_cast<int*>(smem + o.tbl) + 64 * warp;
  int* queue = reinterpret_cast<int*>(smem + o.queue) + 96 * warp;
  const Rows rows = make_rows(smem, o);
  float* sg = reinterpret_cast<float*>(smem + o.sg);
  float* cpart = reinterpret_cast<float*>(smem + o.part);
  float* planes = reinterpret_cast<float*>(smem + o.planes);
  const int cell = blockIdx.x;
  const size_t base = (size_t)cell * p.kk;
  const size_t gbase = (size_t)cell * p.c_ctr * p.out_w;
  for (int k = threadIdx.x; k < p.c_ctr * p.out_w; k += blockDim.x)
    sg[k] = g[gbase + k];
  for (int k = threadIdx.x; k < 3 * nr * p.kk; k += blockDim.x)
    planes[k] = 0.f;
  stage(cx, cy, cz, centers, cell, p, s, rows);

  if (warp < nr * nl) {
    const int i = warp / nl, j = warp - i * nl;
    const int sp = j / p.npart, pt = j - sp * p.npart;
    const int nk = (kEntries - pt + p.npart - 1) / p.npart;
    float* plx = planes + (size_t)i * 3 * p.kk;
    float* ply = plx + p.kk;
    float* plz = ply + p.kk;
    const int nreal = *rows.nreal;
    for (int ri = i; ri < nreal; ri += nr) {
      const int row = rows.srow[ri];
      const float4 c = rows.ctr[row];
      float gq[RP];
#pragma unroll
      for (int q = 0; q < RP; ++q)
        gq[q] = q < p.n_r ? sg[row * p.out_w + sp * p.n_r + q] : 0.f;
      const walk::LiveRuns L =
          walk::live_runs(s, kEntries * sp + pt, p.npart, nk, c.x, c.y, c.z,
                          p.rc2, tbl);
      float ax = 0.f, ay = 0.f, az = 0.f;
      walk::walk(
          L, queue,
          [&](int pos) { return walk::pairs_with(s, pos, c, p.rc2); },
          [&](int pos, bool on) {
            if (!on) return;
            const float4 v = s.lane[pos];
            const float dx = __fsub_rn(v.x, c.x), dy = __fsub_rn(v.y, c.y),
                        dz = __fsub_rn(v.z, c.z);
            const float d2 = walk::dist2_rn(dx, dy, dz);
            float r, rinv;
            walk::radius(d2, p.r_near, r, rinv);
            const float t_raw = __fmul_rn(d2, p.inv_rc2);
            const float t = fminf(t_raw, 1.f);
            const float fc = fc_poly_t(t);
            // d fc / d delta = dfc_term * delta (0 past the clamp of t);
            // d r / d delta = delta / r (0 past the clamps of d2 and r).
            const float dfc_term =
                t_raw <= 1.f ? dfc_poly_t(t) * p.two_inv_rc2 : 0.f;
            const float rinv_m = d2 >= 1e-12f && r <= p.rc ? rinv : 0.f;
            const float rm = fminf(r, p.rc);
            float a = 0.f, b = 0.f;
#pragma unroll
            for (int q = 0; q < RP; ++q) {
              const float u = rm - p.rs[q];
              const float ge = gq[q] * walk::ex2(p.nel2[q] * (u * u));
              a += ge;
              b = fmaf(ge * p.m2eta[q], u, b);
            }
            const float coef = p.scale * (a * dfc_term + fc * b * rinv_m);
            const float gx = coef * dx, gy = coef * dy, gz = coef * dz;
            plx[pos] += gx;
            ply[pos] += gy;
            plz[pos] += gz;
            ax += gx;
            ay += gy;
            az += gz;
          });
      ax = walk::warp_sum(ax);
      ay = walk::warp_sum(ay);
      az = walk::warp_sum(az);
      if (lane == 0) {
        float* cp = cpart + 3 * (row * nl + j);
        cp[0] = ax;
        cp[1] = ay;
        cp[2] = az;
      }
    }
  }
  __syncthreads();

  const size_t plane = (size_t)p.ncells * p.kk;
  for (int l = threadIdx.x; l < p.kk; l += blockDim.x) {
    float vx = 0.f, vy = 0.f, vz = 0.f;
    for (int i = 0; i < nr; ++i) {
      const float* pl = planes + (size_t)i * 3 * p.kk + l;
      vx += pl[0];
      vy += pl[p.kk];
      vz += pl[2 * p.kk];
    }
    dcand[base + l] = vx;
    dcand[plane + base + l] = vy;
    dcand[2 * plane + base + l] = vz;
  }
  for (int row = threadIdx.x; row < p.c_ctr; row += blockDim.x) {
    float vx = 0.f, vy = 0.f, vz = 0.f;
    if (rows.ctr[row].x < walk::kEmpty) {
      for (int j = 0; j < nl; ++j) {
        const float* cp = cpart + 3 * (row * nl + j);
        vx -= cp[0];
        vy -= cp[1];
        vz -= cp[2];
      }
    }
    const size_t crow = (size_t)cell * p.c_ctr + row;
    dctr[crow * 3] = vx;
    dctr[crow * 3 + 1] = vy;
    dctr[crow * 3 + 2] = vz;
  }
}

// The lane geometry comes from the wrapper (WindowGeometry and
// window_runs in cuda_window.py, which the plain version's lanes follow
// too); it is checked here: species s owns runs 27 s .. 27 s + 26, which
// tile [0, kk) in order with one length per species, packed center rows
// ascend, and every center row's self lane lies inside its species' runs.
int make_params(WinParams& p, int ncells, int npres, int kk,
                const int* run_first, const int* run_len, const int* ctr_off,
                const int* self_shift, int n_r, const float* eta,
                const float* rs, double rc, double scale) {
  if (npres < 1 || npres > kMaxSpecies || n_r < 1 || n_r > kMaxRadial ||
      kk < 1 || ctr_off[0] != 0)
    return (int)cudaErrorInvalidValue;
  const int nruns = kEntries * npres;
  int next = 0;
  for (int r = 0; r < nruns; ++r) {
    if (run_first[r] != next || run_len[r] < 0 ||
        run_len[r] != run_len[r - r % kEntries])
      return (int)cudaErrorInvalidValue;
    next += run_len[r];
    p.runs.first[r] = run_first[r];
    p.runs.len[r] = run_len[r];
  }
  if (next != kk) return (int)cudaErrorInvalidValue;
  p.runs.nruns = nruns;
  for (int s = 0; s < npres; ++s) {
    const int rows = ctr_off[s + 1] - ctr_off[s];
    const int lo = run_first[kEntries * s];
    const int hi = lo + kEntries * run_len[kEntries * s];
    if (rows < 0) return (int)cudaErrorInvalidValue;
    if (rows > 0 && (ctr_off[s] + self_shift[s] < lo ||
                     ctr_off[s + 1] - 1 + self_shift[s] >= hi))
      return (int)cudaErrorInvalidValue;
  }
  p.ncells = ncells;
  p.npres = npres;
  p.n_r = n_r;
  p.out_w = npres * n_r;
  p.npart = 1;
  p.rc = (float)rc;
  p.rc2 = (float)(rc * rc);
  p.inv_rc2 = (float)(1.0 / (rc * rc));
  p.two_inv_rc2 = (float)(2.0 / (rc * rc));
  p.r_near = (float)(rc * (1.0 - 1e-6));
  p.scale = (float)scale;
  p.kk = kk;
  p.c_ctr = ctr_off[npres];
  for (int s = 0; s < kMaxSpecies; ++s) {
    const bool on = s < npres;
    p.ctr_off[s] = on ? ctr_off[s] : p.c_ctr;
    p.self_shift[s] = on ? self_shift[s] : 0;
  }
  p.ctr_off[kMaxSpecies] = p.c_ctr;
  for (int i = 0; i < kMaxRadial; ++i) {
    const bool on = i < n_r;
    p.rs[i] = on ? rs[i] : 0.f;
    p.nel2[i] = on ? (float)(-(double)eta[i] * 1.4426950408889634) : 0.f;
    p.m2eta[i] = on ? -2.f * eta[i] : 0.f;
  }
  return 0;
}

// Parts of a species block's runs in the backward: the fewest that make at
// least 4 run groups, so that a cell's units outnumber its warps.
int min_parts(int npres) {
  int k = 1;
  while (npres * k < 4) k <<= 1;
  return k;
}

// The radial functions padded to a power of two (4 at least).
int radial_pad(int n_r) {
  int rp = 4;
  while (rp < n_r) rp <<= 1;
  return rp;
}

template <int RP>
cudaError_t launch_fwd(const float* cx, const float* cy, const float* cz,
                       const float* centers, float* out, const WinParams& p,
                       int nw, cudaStream_t stream) {
  const size_t smem = layout(p, nw, false).bytes;
  cudaError_t err = walk::prepare(window_radial_fwd_kernel<RP>, smem);
  if (err != cudaSuccess) return err;
  window_radial_fwd_kernel<RP><<<p.ncells, 32 * nw, smem, stream>>>(
      cx, cy, cz, centers, out, p);
  return cudaGetLastError();
}

template <int RP>
cudaError_t launch_bwd(const float* cx, const float* cy, const float* cz,
                       const float* centers, const float* g, float* dcand,
                       float* dctr, const WinParams& p, int nw,
                       cudaStream_t stream) {
  const size_t smem = layout(p, nw, true).bytes;
  cudaError_t err = walk::prepare(window_radial_bwd_kernel<RP>, smem);
  if (err != cudaSuccess) return err;
  window_radial_bwd_kernel<RP><<<p.ncells, 32 * nw, smem, stream>>>(
      cx, cy, cz, centers, g, dcand, dctr, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int window_radial_fwd(const float* cx, const float* cy, const float* cz,
                      const float* centers, float* out, int ncells, int npres,
                      int kk, const int* run_first, const int* run_len,
                      const int* ctr_off, const int* self_shift, int n_r,
                      const float* eta, const float* rs, double rc,
                      double scale, void* stream) {
  if (ncells <= 0) return 0;
  WinParams p;
  const int bad = make_params(p, ncells, npres, kk, run_first, run_len,
                              ctr_off, self_shift, n_r, eta, rs, rc, scale);
  if (bad) return bad;
  const int nw = walk::block_warps(ncells);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (radial_pad(n_r)) {
    case 4: return (int)launch_fwd<4>(cx, cy, cz, centers, out, p, nw, st);
    case 8: return (int)launch_fwd<8>(cx, cy, cz, centers, out, p, nw, st);
    case 16: return (int)launch_fwd<16>(cx, cy, cz, centers, out, p, nw, st);
    default: return (int)launch_fwd<32>(cx, cy, cz, centers, out, p, nw, st);
  }
}

int window_radial_bwd(const float* cx, const float* cy, const float* cz,
                      const float* centers, const float* g, float* dcand,
                      float* dctr, int ncells, int npres, int kk,
                      const int* run_first, const int* run_len,
                      const int* ctr_off, const int* self_shift, int n_r,
                      const float* eta, const float* rs, double rc,
                      double scale, void* stream) {
  if (ncells <= 0) return 0;
  WinParams p;
  const int bad = make_params(p, ncells, npres, kk, run_first, run_len,
                              ctr_off, self_shift, n_r, eta, rs, rc, scale);
  if (bad) return bad;
  // Parts of a species block's runs: from the forward's, the fewest whose
  // planes fit, two blocks an SM when there are more cells than SMs.
  const int nw = walk::block_warps(ncells);
  const size_t budget =
      nw == 32 ? (size_t)walk::kSmemLimit : (size_t)walk::kSmemLimit / 2 - 1024;
  int npart = 0;
  for (int k = min_parts(npres); npres * k <= nw && k <= kEntries; k <<= 1) {
    p.npart = k;
    const size_t smem = layout(p, nw, true).bytes;
    if (smem <= (size_t)walk::kSmemLimit && npart == 0) npart = k;
    if (smem <= budget) {
      npart = k;
      break;
    }
  }
  if (npart == 0) return (int)cudaErrorInvalidValue;
  p.npart = npart;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (radial_pad(n_r)) {
    case 4:
      return (int)launch_bwd<4>(cx, cy, cz, centers, g, dcand, dctr, p, nw, st);
    case 8:
      return (int)launch_bwd<8>(cx, cy, cz, centers, g, dcand, dctr, p, nw, st);
    case 16:
      return (int)launch_bwd<16>(cx, cy, cz, centers, g, dcand, dctr, p, nw,
                                 st);
    default:
      return (int)launch_bwd<32>(cx, cy, cz, centers, g, dcand, dctr, p, nw,
                                 st);
  }
}

}  // extern "C"
