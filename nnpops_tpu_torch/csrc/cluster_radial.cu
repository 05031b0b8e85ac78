// Cluster-pair radial AEV, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_cluster.py:49
// make_cluster_radial_kernel: fwd_kernel (pallas_call at :180) and
// bwd_kernel (:191). Wrapper, autograd Function and plain PyTorch version:
// nnpops_tpu_torch/ops/cuda_cluster.py; the selection that feeds it:
// nnpops_tpu_torch/neighbors/clusters.py.
//
// Semantics, for the i-clusters of one species: jx/jy/jz [ncl, lanes] hold
// each i-cluster's gathered j-cluster atoms (image shifts applied, empty
// slots at FAR) in j-species-major lane blocks [lane_lo[s], lane_hi[s]), a
// j-cluster entry of cl lanes after another; centers [ncl, cl, 3] the
// i-cluster's own atoms. The i-cluster itself is the first j-cluster of its
// own species' block, so row r's self lane is self_off + r. A pair is valid
// when d2 < rc^2 and it is not the self lane; fc = 0.5 cos(pi r / rc) +
// 0.5; out[i, r, s*R + q] = scale * sum over the lanes of species s of fc *
// exp(-eta_q (r - rs_q)^2). The backward recomputes the geometry and writes
// the lane cotangents dj [3, ncl, lanes] and the center cotangents [ncl,
// cl, 3]; the scatter of dj back to atoms is the adjoint of the caller's
// gather. Centers at or beyond FAR/2 are empty slots: their rows are 0 and
// they evaluate no pair (the Pallas kernel pairs them with the empty lanes
// of their own cluster and writes rows no caller reads).
//
// What bounds it on the H100: the bytes of the lane planes (12 bytes a
// lane, 640 or 896 lanes an i-cluster at 26,010 atoms) against a distance
// test a (center, lane) pair and, for the ~9 % inside the cutoff, about 18
// SFU and 86 FP32 operations forward.
//
// Design: one block per i-cluster, two warps per species block. A warp
// walks every other chunk of 32 lanes of its block (a lane a thread, read
// once from device memory) and skips every chunk with no occupied lane (the
// selection compacts the lists, so the block's trailing entries cost one
// load and a ballot). A chunk is tested against all of the cluster's real
// rows at once: eight independent distance tests a thread, each row's
// valid lanes appended to that row's queue in lane order. A row's queue is
// handed on 32 pairs at a time (then the rest at the end), so the
// Gaussians are spent on valid pairs only, four a thread, 32 / G pairs a
// step (G = R/4). Testing a chunk against the rows together costs less
// than boxing each j-cluster entry and skipping it per row: eight rows of
// one small cluster share most of their entries.
// - Forward: each warp keeps its (row, species) sums in shared memory
//   across the row's batches; the block adds the two warps' in order.
// - Backward, no float atomics: a batch holds one row's pairs, so its
//   lanes are distinct; each pair's thread adds the lane's cotangent into
//   its species block's plane (a lane belongs to one warp's chunks), and
//   the center's cotangent is
//   summed over the warp into the warp's partial row. The block sums a
//   row's partials in species order; every lane is written once.
// Every sum runs in a fixed order: both directions are bitwise repeatable.
// The plain version's decisions are taken on its rounding: d2 < rc^2
// rounded op by op, the self lane by index, the clamp of d2 at 1e-12 and
// min(r, rc) with r rounded as PyTorch's sqrt within 1e-6 of rc; the
// backward stops the gradient where those clamps do. Intrinsics:
// rsqrt.approx for 1/r and r, ex2.approx for the Gaussians, __cosf and
// __sinf (the SFU's) on [0, pi) for the cutoff.
#include <cuda_runtime.h>

#include <cstdint>

#include "window_walk.cuh"

namespace {

constexpr int kMaxCluster = 8;
constexpr int kMaxSpecies = 8;
constexpr int kMaxRadial = 32;
constexpr int kQueue = 64;        // a row's queue: a batch and a chunk
constexpr int kSplit = 2;         // warps a species block
using walk::kFull;

struct ClusterParams {
  int ncl, cl, lanes, npres, n_r, out_w, self_off, blk_max;
  float rc, rc2, pi_rc, scale, r_near;
  int lane_lo[kMaxSpecies + 1];   // species block s: [lane_lo[s], +1)
  float rs[kMaxRadial], nel2[kMaxRadial], m2eta[kMaxRadial];
};

// Shared memory, as offsets from the dynamic __shared__ array: the
// centers, then per warp the rows' queues [kMaxCluster][kQueue], the batch
// scratch (32 float2) and the forward's row sums [kMaxCluster][RP] or the
// backward's partial rows [kMaxCluster][3] and lane plane [3][blk_max].
struct Layout {
  size_t ctr, queue, qd, rows, plane, bytes;
};

__host__ __device__ inline Layout layout(const ClusterParams& p, int rp,
                                         bool bwd) {
  Layout o;
  size_t at = 0;
  const int nw = p.npres * kSplit;
  o.ctr = walk::region(at, (size_t)16 * kMaxCluster);
  o.queue = walk::region(at, (size_t)4 * kMaxCluster * kQueue * nw);
  o.qd = walk::region(at, (size_t)256 * nw);
  o.rows = walk::region(at, (size_t)4 * kMaxCluster * (bwd ? 3 : rp) * nw);
  o.plane = bwd ? walk::region(at, (size_t)12 * p.blk_max * p.npres) : 0;
  o.bytes = at;
  return o;
}

// The block's setup: the i-cluster's centers (x, y, z and the self lane's
// index as the bits of w) and the mask of its real rows.
__device__ __forceinline__ unsigned stage_rows(
    const float* __restrict__ centers, int i, const ClusterParams& p,
    float4* ctr) {
  const size_t cbase = (size_t)i * p.cl * 3;
  for (int r = threadIdx.x; r < p.cl; r += blockDim.x)
    ctr[r] = make_float4(centers[cbase + 3 * r], centers[cbase + 3 * r + 1],
                         centers[cbase + 3 * r + 2],
                         __int_as_float(p.self_off + r));
  __syncthreads();
  unsigned real = 0u;
  for (int r = 0; r < p.cl; ++r)
    if (ctr[r].x < walk::kEmpty) real |= 1u << r;
  return real;
}

// One warp's walk of its share of species block sp of i-cluster i (the
// block's chunks of 32 lanes part, part + kSplit, ...): each chunk that
// holds an occupied lane is tested against every real row, the valid
// lanes join the row's queue, and `flush(r, n, qn)` takes a row's first n
// queued pairs (32 whenever it has that many, the rest at the end).
template <class Flush>
__device__ inline void block_walk(const float* __restrict__ jx,
                                  const float* __restrict__ jy,
                                  const float* __restrict__ jz, int i,
                                  int sp, int part, unsigned real,
                                  const ClusterParams& p, const float4* ctr,
                                  int* queue, Flush flush) {
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)i * p.lanes;
  const int lo = p.lane_lo[sp], hi = p.lane_lo[sp + 1];
  int qn[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) qn[r] = 0;
  for (int b = lo + 32 * part; b < hi; b += 32 * kSplit) {
    const int l = b + lane;
    float4 v = make_float4(walk::kEmpty, 0.f, 0.f, 0.f);
    if (l < hi)
      v = make_float4(jx[base + l], jy[base + l], jz[base + l], 0.f);
    if (!__any_sync(kFull, v.x < walk::kEmpty)) continue;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (!((real >> r) & 1u)) continue;
      const float4 c = ctr[r];
      float dx, dy, dz;
      const bool valid = walk::dist2_to(v, c, dx, dy, dz) < p.rc2 &&
                         l != __float_as_int(c.w);
      const unsigned bal = __ballot_sync(kFull, valid);
      if (valid)
        queue[r * kQueue + qn[r] + __popc(bal & walk::lanemask_lt())] = l;
      qn[r] += __popc(bal);
    }
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (qn[r] >= 32) flush(r, 32, qn[r]);
  }
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (qn[r] > 0) flush(r, qn[r], qn[r]);
}

// Drops a row's first n queued pairs (the rest move to the front).
__device__ __forceinline__ void pop(int* q, int n, int& qn) {
  const int lane = threadIdx.x & 31, rest = qn - n;
  const int t = lane < rest ? q[n + lane] : 0;
  __syncwarp();
  if (lane < rest) q[lane] = t;
  __syncwarp();
  qn = rest;
}

template <int RP>
__global__ void __launch_bounds__(32 * kSplit * kMaxSpecies, 2)
cluster_radial_fwd_kernel(const float* __restrict__ jx,
                          const float* __restrict__ jy,
                          const float* __restrict__ jz,
                          const float* __restrict__ centers,
                          float* __restrict__ out, const ClusterParams p) {
  constexpr int G = RP / 4, PAIRS = 32 / G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = walk::warp_id(), lane = threadIdx.x & 31;
  const Layout o = layout(p, RP, false);
  float4* ctr = reinterpret_cast<float4*>(smem + o.ctr);
  int* queue =
      reinterpret_cast<int*>(smem + o.queue) + kMaxCluster * kQueue * warp;
  float2* qd = reinterpret_cast<float2*>(smem + o.qd) + 32 * warp;
  float* rows = reinterpret_cast<float*>(smem + o.rows) +
                kMaxCluster * RP * warp;
  const int i = blockIdx.x, sp = warp / kSplit, part = warp % kSplit;
  for (int k = lane; k < kMaxCluster * RP; k += 32) rows[k] = 0.f;
  const unsigned real = stage_rows(centers, i, p, ctr);
  const size_t base = (size_t)i * p.lanes;

  float rsq[4], nel2q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rsq[k] = p.rs[4 * (lane % G) + k];
    nel2q[k] = p.nel2[4 * (lane % G) + k];
  }
  block_walk(jx, jy, jz, i, sp, part, real, p, ctr, queue,
             [&](int r, int n, int& qn) {
    int* q = queue + r * kQueue;
    __syncwarp();
    const bool on = lane < n;
    float rm = 0.f, fc = 0.f;
    if (on) {
      const int l = q[lane];
      const float4 v = make_float4(jx[base + l], jy[base + l], jz[base + l],
                                   0.f);
      float dx, dy, dz, rr, rinv;
      walk::radius(walk::dist2_to(v, ctr[r], dx, dy, dz), p.r_near, rr, rinv);
      fc = fmaf(0.5f, __cosf(p.pi_rc * rr), 0.5f);
      rm = fminf(rr, p.rc);
    }
    qd[lane] = make_float2(rm, fc);
    __syncwarp();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += PAIRS) {
      const float2 e = qd[k0 + lane / G];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float du = e.x - rsq[k];
        acc[k] = fmaf(e.y, walk::ex2(nel2q[k] * (du * du)), acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      for (int off = G; off < 32; off <<= 1)
        acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    if (lane < G) {
      float* rr_ = rows + r * RP + 4 * lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) rr_[k] += acc[k];
    }
    pop(q, n, qn);
  });
  __syncthreads();
  // A row's sum over the species block's warps, in order.
  const float* sums = reinterpret_cast<const float*>(smem + o.rows);
  float* orow = out + (size_t)i * p.cl * p.out_w;
  for (int k = threadIdx.x; k < p.cl * p.out_w; k += blockDim.x) {
    const int r = k / p.out_w, col = k - r * p.out_w;
    const int s = col / p.n_r, q = col - s * p.n_r;
    float v = 0.f;
    if ((real >> r) & 1u)
      for (int w = s * kSplit; w < (s + 1) * kSplit; ++w)
        v += sums[(w * kMaxCluster + r) * RP + q];
    orow[k] = p.scale * v;
  }
}

template <int RP>
__global__ void __launch_bounds__(32 * kSplit * kMaxSpecies, 2)
cluster_radial_bwd_kernel(const float* __restrict__ jx,
                          const float* __restrict__ jy,
                          const float* __restrict__ jz,
                          const float* __restrict__ centers,
                          const float* __restrict__ g,
                          float* __restrict__ dj,
                          float* __restrict__ dctr, const ClusterParams p) {
  constexpr int G = RP / 4, PAIRS = 32 / G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = walk::warp_id(), lane = threadIdx.x & 31;
  const Layout o = layout(p, RP, true);
  float4* ctr = reinterpret_cast<float4*>(smem + o.ctr);
  int* queue =
      reinterpret_cast<int*>(smem + o.queue) + kMaxCluster * kQueue * warp;
  float* qd = reinterpret_cast<float*>(smem + o.qd) + 64 * warp;
  float* cpart = reinterpret_cast<float*>(smem + o.rows);  // [nw][cl][3]
  const int i = blockIdx.x, sp = warp / kSplit, part = warp % kSplit;
  float* plane = reinterpret_cast<float*>(smem + o.plane) +
                 3 * p.blk_max * sp;          // the species block's lanes
  const int lo = p.lane_lo[sp], nb = p.lane_lo[sp + 1] - lo;
  for (int k = threadIdx.x; k < 3 * p.blk_max * p.npres; k += blockDim.x)
    reinterpret_cast<float*>(smem + o.plane)[k] = 0.f;
  for (int k = lane; k < 3 * kMaxCluster; k += 32)
    cpart[3 * kMaxCluster * warp + k] = 0.f;
  const unsigned real = stage_rows(centers, i, p, ctr);
  const size_t base = (size_t)i * p.lanes;

  const int gi = lane % G;
  float rsq[4], nel2q[4], m2q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rsq[k] = p.rs[4 * gi + k];
    nel2q[k] = p.nel2[4 * gi + k];
    m2q[k] = p.m2eta[4 * gi + k];
  }
  const float* gi_ = g + (size_t)i * p.cl * p.out_w + sp * p.n_r;
  block_walk(jx, jy, jz, i, sp, part, real, p, ctr, queue,
             [&](int r, int n, int& qn) {
    int* q = queue + r * kQueue;
    __syncwarp();
    const bool on = lane < n;
    const float4 c = ctr[r];
    int l = lo;
    float dx = 0.f, dy = 0.f, dz = 0.f, rm = 0.f, fc = 0.f, dfc = 0.f,
          rinv_c = 0.f, rinv_m = 0.f;
    if (on) {
      l = q[lane];
      const float4 v = make_float4(jx[base + l], jy[base + l], jz[base + l],
                                   0.f);
      float rr, rinv;
      const float d2 = walk::dist2_to(v, c, dx, dy, dz);
      walk::radius(d2, p.r_near, rr, rinv);
      const float x = p.pi_rc * rr;
      fc = fmaf(0.5f, __cosf(x), 0.5f);
      dfc = -0.5f * p.pi_rc * __sinf(x);
      rinv_c = d2 >= 1e-12f ? rinv : 0.f;
      rinv_m = d2 >= 1e-12f && rr <= p.rc ? rinv : 0.f;
      rm = fminf(rr, p.rc);
    }
    qd[lane] = rm;
    float gq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int qq = 4 * gi + k;
      gq[k] = qq < p.n_r ? gi_[r * p.out_w + qq] : 0.f;
    }
    __syncwarp();
    float a_own = 0.f, b_own = 0.f;
    for (int k0 = 0; k0 < n; k0 += PAIRS) {
      const float rmk = qd[k0 + lane / G];
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
      const bool mine = lane >= k0 && lane < k0 + PAIRS;
      const int src = mine ? G * (lane - k0) : 0;
      const float av = __shfl_sync(kFull, ac, src),
                  bv = __shfl_sync(kFull, bc, src);
      if (mine) {
        a_own = av;
        b_own = bv;
      }
    }
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if (on) {
      const float coef =
          p.scale * (a_own * dfc * rinv_c + fc * b_own * rinv_m);
      gx = coef * dx;
      gy = coef * dy;
      gz = coef * dz;
      float* pl = plane + (l - lo);
      pl[0] += gx;
      pl[p.blk_max] += gy;
      pl[2 * p.blk_max] += gz;
    }
    gx = walk::warp_sum(gx);
    gy = walk::warp_sum(gy);
    gz = walk::warp_sum(gz);
    if (lane == 0) {
      float* cp = cpart + 3 * (kMaxCluster * warp + r);
      cp[0] += gx;
      cp[1] += gy;
      cp[2] += gz;
    }
    pop(q, n, qn);
  });
  __syncthreads();
  const size_t lplane = (size_t)p.ncl * p.lanes;
  for (int k = 32 * part + lane; k < nb; k += 32 * kSplit) {
    dj[base + lo + k] = plane[k];
    dj[lplane + base + lo + k] = plane[p.blk_max + k];
    dj[2 * lplane + base + lo + k] = plane[2 * p.blk_max + k];
  }
  for (int r = threadIdx.x; r < p.cl; r += blockDim.x) {
    float vx = 0.f, vy = 0.f, vz = 0.f;
    if ((real >> r) & 1u) {
      for (int w = 0; w < p.npres * kSplit; ++w) {
        const float* cp = cpart + 3 * (kMaxCluster * w + r);
        vx -= cp[0];
        vy -= cp[1];
        vz -= cp[2];
      }
    }
    const size_t crow = (size_t)i * p.cl + r;
    dctr[crow * 3] = vx;
    dctr[crow * 3 + 1] = vy;
    dctr[crow * 3 + 2] = vz;
  }
}

// The lane geometry comes from the wrapper (cuda_cluster.py, whose plain
// version uses the same bounds); it is checked here: the species blocks
// tile [0, lanes) in order, and every row's self lane lies inside the block
// at self_off.
int make_params(ClusterParams& p, int ncl, int cl, int lanes, int npres,
                const int* lane_lo, const int* lane_hi, int self_off, int n_r,
                const float* eta, const float* rs, double rc, double scale) {
  if (cl < 1 || cl > kMaxCluster || npres < 1 || npres > kMaxSpecies ||
      n_r < 1 || n_r > kMaxRadial || lanes < 1 || lane_lo[0] != 0 ||
      lane_hi[npres - 1] != lanes)
    return (int)cudaErrorInvalidValue;
  bool self_in = false;
  p.blk_max = 0;
  for (int sp = 0; sp < npres; ++sp) {
    if (lane_hi[sp] < lane_lo[sp] || (sp > 0 && lane_lo[sp] != lane_hi[sp - 1]))
      return (int)cudaErrorInvalidValue;
    if (self_off == lane_lo[sp] && self_off + cl <= lane_hi[sp]) self_in = true;
    p.blk_max = max(p.blk_max, lane_hi[sp] - lane_lo[sp]);
  }
  if (!self_in) return (int)cudaErrorInvalidValue;
  p.ncl = ncl;
  p.cl = cl;
  p.lanes = lanes;
  p.npres = npres;
  p.n_r = n_r;
  p.out_w = npres * n_r;
  p.self_off = self_off;
  p.rc = (float)rc;
  p.rc2 = (float)(rc * rc);
  p.pi_rc = (float)(3.14159265358979323846 / rc);
  p.r_near = (float)(rc * (1.0 - 1e-6));
  p.scale = (float)scale;
  for (int sp = 0; sp <= kMaxSpecies; ++sp)
    p.lane_lo[sp] = sp < npres ? lane_lo[sp] : lanes;
  for (int k = 0; k < kMaxRadial; ++k) {
    const bool on = k < n_r;
    p.rs[k] = on ? rs[k] : 0.f;
    p.nel2[k] = on ? (float)(-(double)eta[k] * 1.4426950408889634) : 0.f;
    p.m2eta[k] = on ? -2.f * eta[k] : 0.f;
  }
  return 0;
}

int radial_pad(int n_r) {
  int rp = 4;
  while (rp < n_r) rp <<= 1;
  return rp;
}

template <int RP>
cudaError_t launch_fwd(const float* jx, const float* jy, const float* jz,
                       const float* centers, float* out,
                       const ClusterParams& p, cudaStream_t stream) {
  const size_t smem = layout(p, RP, false).bytes;
  cudaError_t err = walk::prepare(cluster_radial_fwd_kernel<RP>, smem);
  if (err != cudaSuccess) return err;
  cluster_radial_fwd_kernel<RP><<<p.ncl, 32 * kSplit * p.npres, smem,
                                  stream>>>(
      jx, jy, jz, centers, out, p);
  return cudaGetLastError();
}

template <int RP>
cudaError_t launch_bwd(const float* jx, const float* jy, const float* jz,
                       const float* centers, const float* g, float* dj,
                       float* dctr, const ClusterParams& p,
                       cudaStream_t stream) {
  const size_t smem = layout(p, RP, true).bytes;
  cudaError_t err = walk::prepare(cluster_radial_bwd_kernel<RP>, smem);
  if (err != cudaSuccess) return err;
  cluster_radial_bwd_kernel<RP><<<p.ncl, 32 * kSplit * p.npres, smem,
                                  stream>>>(
      jx, jy, jz, centers, g, dj, dctr, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cluster_radial_fwd(const float* jx, const float* jy, const float* jz,
                       const float* centers, float* out, int ncl, int cl,
                       int lanes, int npres, const int* lane_lo,
                       const int* lane_hi, int self_off, int n_r,
                       const float* eta, const float* rs, double rc,
                       double scale, void* stream) {
  if (ncl <= 0) return 0;
  ClusterParams p;
  const int bad = make_params(p, ncl, cl, lanes, npres, lane_lo, lane_hi,
                              self_off, n_r, eta, rs, rc, scale);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (radial_pad(n_r)) {
    case 4: return (int)launch_fwd<4>(jx, jy, jz, centers, out, p, st);
    case 8: return (int)launch_fwd<8>(jx, jy, jz, centers, out, p, st);
    case 16: return (int)launch_fwd<16>(jx, jy, jz, centers, out, p, st);
    default: return (int)launch_fwd<32>(jx, jy, jz, centers, out, p, st);
  }
}

int cluster_radial_bwd(const float* jx, const float* jy, const float* jz,
                       const float* centers, const float* g, float* dj,
                       float* dctr, int ncl, int cl, int lanes, int npres,
                       const int* lane_lo, const int* lane_hi, int self_off,
                       int n_r, const float* eta, const float* rs, double rc,
                       double scale, void* stream) {
  if (ncl <= 0) return 0;
  ClusterParams p;
  const int bad = make_params(p, ncl, cl, lanes, npres, lane_lo, lane_hi,
                              self_off, n_r, eta, rs, rc, scale);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (radial_pad(n_r)) {
    case 4:
      return (int)launch_bwd<4>(jx, jy, jz, centers, g, dj, dctr, p, st);
    case 8:
      return (int)launch_bwd<8>(jx, jy, jz, centers, g, dj, dctr, p, st);
    case 16:
      return (int)launch_bwd<16>(jx, jy, jz, centers, g, dj, dctr, p, st);
    default:
      return (int)launch_bwd<32>(jx, jy, jz, centers, g, dj, dctr, p, st);
  }
}

}  // extern "C"
