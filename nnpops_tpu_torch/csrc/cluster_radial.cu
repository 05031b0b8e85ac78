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
// slots at FAR) in j-species-major lane blocks [lane_lo[s], lane_hi[s]);
// centers [ncl, cl, 3] the i-cluster's own atoms. The i-cluster itself is
// the first j-cluster of its own species' block, so row r's self lane is
// self_off + r. A pair is valid when d2 < rc^2 and it is not the self lane;
// fc = 0.5 cos(pi r / rc) + 0.5; out[i, r, s*R + q] = scale * sum over the
// lanes of species s of fc * exp(-eta_q (r - rs_q)^2). The backward
// recomputes the geometry and writes the lane cotangents
// dj [3, ncl, lanes] and the center cotangents [ncl, cl, 3]; the scatter
// of dj back to atoms is the adjoint of the caller's gather. Centers at or
// beyond FAR/2 are empty slots: their rows are 0 and they evaluate no pair
// (the Pallas kernel pairs them with the empty lanes of their own cluster
// and writes rows no caller reads).
//
// What bounds it on the H100: bytes. Every (center, lane) pair is tested
// (about 10 operations); a valid pair costs a sqrt, a cosine and R = 16
// Gaussians (about 120 operations forward, 200 backward), and about 8 % of
// the pairs are valid at water density. Per i-cluster 3 x lanes floats and
// cl x 3 centers come in and cl x P*R go out (the backward also writes
// 3 x lanes): 12 bytes a lane against about 160 operations forward (8 rows
// tested), under the card's 20 operations a byte.
//
// Design: one block per i-cluster, a warp per center row (cl <= 8). The
// block stages the cluster's j-lanes in shared memory. A warp walks each
// species block 32 lanes at a time: each lane tests its own pair,
// __ballot_sync collects the valid ones, and the valid pairs are taken
// 32 / R_pad at a time with one lane per Gaussian, so exps are spent on
// valid pairs only (the window radial kernel's scheme). The species sums
// are warp shuffles at the end of each block. The backward keeps each
// row's lane cotangents in its own shared-memory row (a pair is written
// by one lane, no atomics) and the block adds the rows in row order: two
// calls are bitwise equal.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // also the largest cluster
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSpecies = 8;
constexpr int kMaxRadial = 32;
constexpr float kEmptyRow = 0.5e6f;       // FAR / 2
constexpr unsigned kFull = 0xffffffffu;

struct ClusterParams {
  int ncl, cl, lanes, npres, n_r, r_pad, groups, out_w, self_off;
  float rc, rc2, pi_rc, scale;
  int lane_lo[kMaxSpecies], lane_hi[kMaxSpecies];
  float eta[kMaxRadial], rs[kMaxRadial];
};

__device__ __forceinline__ void stage(const float* __restrict__ jx,
                                      const float* __restrict__ jy,
                                      const float* __restrict__ jz, int i,
                                      int lanes, float* sx, float* sy,
                                      float* sz) {
  const size_t base = (size_t)i * lanes;
  for (int l = threadIdx.x; l < lanes; l += kThreads) {
    sx[l] = jx[base + l];
    sy[l] = jy[base + l];
    sz[l] = jz[base + l];
  }
}

// Lane of the group's pair among the next `groups` valid lanes of `m`
// (-1 when fewer remain); removes them from `m`. Warp-uniform.
__device__ __forceinline__ int take_pairs(unsigned& m, int groups, int grp) {
  int src = -1;
  for (int j = 0; j < groups; ++j) {
    const int b = __ffs(m) - 1;
    if (j == grp) src = b;
    if (m) m &= m - 1;
  }
  return src;
}

__global__ void __launch_bounds__(kThreads)
cluster_radial_fwd_kernel(const float* __restrict__ jx,
                          const float* __restrict__ jy,
                          const float* __restrict__ jz,
                          const float* __restrict__ centers,
                          float* __restrict__ out, const ClusterParams p) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + p.lanes;
  float* sz = sy + p.lanes;
  const int i = blockIdx.x;
  stage(jx, jy, jz, i, p.lanes, sx, sy, sz);
  __syncthreads();
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (row >= p.cl) return;                       // whole warp leaves
  const size_t crow = (size_t)i * p.cl + row;
  const float px = centers[crow * 3], py = centers[crow * 3 + 1],
              pz = centers[crow * 3 + 2];
  const bool empty = px >= kEmptyRow;
  const int self_lane = p.self_off + row;
  const int q = lane & (p.r_pad - 1), grp = lane / p.r_pad;
  const bool q_on = q < p.n_r;
  const float eta_q = q_on ? p.eta[q] : 0.f, rs_q = q_on ? p.rs[q] : 0.f;
  float* orow = out + crow * p.out_w;

  for (int s = 0; s < p.npres; ++s) {
    float acc = 0.f;
    const int hi = p.lane_hi[s];
    for (int base = p.lane_lo[s]; base < hi && !empty; base += 32) {
      const int l = base + lane;
      float r = 0.f, fc = 0.f;
      bool valid = false;
      if (l < hi) {
        const float dx = sx[l] - px, dy = sy[l] - py, dz = sz[l] - pz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        valid = d2 < p.rc2 && l != self_lane;
        if (valid) {
          r = sqrtf(fmaxf(d2, 1e-12f));
          fc = 0.5f * cosf(p.pi_rc * r) + 0.5f;
        }
      }
      unsigned m = __ballot_sync(kFull, valid);
      while (m) {
        const int src = take_pairs(m, p.groups, grp);
        const float rr = __shfl_sync(kFull, r, src < 0 ? 0 : src);
        const float ff = __shfl_sync(kFull, fc, src < 0 ? 0 : src);
        if (src >= 0 && q_on) {
          const float u = fminf(rr, p.rc) - rs_q;
          acc += ff * expf(-eta_q * (u * u));
        }
      }
    }
    for (int off = p.r_pad; off < 32; off <<= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane < p.n_r) orow[s * p.n_r + lane] = p.scale * acc;
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_radial_bwd_kernel(const float* __restrict__ jx,
                          const float* __restrict__ jy,
                          const float* __restrict__ jz,
                          const float* __restrict__ centers,
                          const float* __restrict__ g,
                          float* __restrict__ dj,
                          float* __restrict__ dctr, const ClusterParams p) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + p.lanes;
  float* sz = sy + p.lanes;
  float* gl = sz + p.lanes;                      // [cl][3][lanes]
  const int i = blockIdx.x;
  stage(jx, jy, jz, i, p.lanes, sx, sy, sz);
  for (int l = threadIdx.x; l < 3 * p.cl * p.lanes; l += kThreads) gl[l] = 0.f;
  __syncthreads();
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (row < p.cl) {
    const size_t crow = (size_t)i * p.cl + row;
    const float px = centers[crow * 3], py = centers[crow * 3 + 1],
                pz = centers[crow * 3 + 2];
    const bool empty = px >= kEmptyRow;
    const int self_lane = p.self_off + row;
    const int q = lane & (p.r_pad - 1), grp = lane / p.r_pad;
    const bool q_on = q < p.n_r;
    const float eta_q = q_on ? p.eta[q] : 0.f, rs_q = q_on ? p.rs[q] : 0.f;
    float* grow = gl + (size_t)row * 3 * p.lanes;
    float cgx = 0.f, cgy = 0.f, cgz = 0.f;       // this lane's center sums

    for (int s = 0; s < p.npres && !empty; ++s) {
      const float g_q = q_on ? g[crow * p.out_w + s * p.n_r + q] : 0.f;
      const int hi = p.lane_hi[s];
      for (int base = p.lane_lo[s]; base < hi; base += 32) {
        const int l = base + lane;
        float dx = 0.f, dy = 0.f, dz = 0.f, r = 1.f, fc = 0.f, dfc = 0.f;
        bool valid = false;
        if (l < hi) {
          dx = sx[l] - px;
          dy = sy[l] - py;
          dz = sz[l] - pz;
          const float d2 = dx * dx + dy * dy + dz * dz;
          valid = d2 < p.rc2 && l != self_lane;
          if (valid) {
            r = sqrtf(fmaxf(d2, 1e-12f));
            fc = 0.5f * cosf(p.pi_rc * r) + 0.5f;
            dfc = -0.5f * p.pi_rc * sinf(p.pi_rc * r);
          }
        }
        unsigned m = __ballot_sync(kFull, valid);
        while (m) {
          const int src = take_pairs(m, p.groups, grp);
          const int from = src < 0 ? 0 : src;
          const float rr = __shfl_sync(kFull, r, from);
          const float ff = __shfl_sync(kFull, fc, from);
          const float dd = __shfl_sync(kFull, dfc, from);
          const float ex = __shfl_sync(kFull, dx, from);
          const float ey = __shfl_sync(kFull, dy, from);
          const float ez = __shfl_sync(kFull, dz, from);
          float a = 0.f, b = 0.f;
          if (src >= 0 && q_on) {
            const float u = fminf(rr, p.rc) - rs_q;
            a = g_q * expf(-eta_q * (u * u));
            b = a * (eta_q * (rr - rs_q));
          }
          for (int off = 1; off < p.r_pad; off <<= 1) {
            a += __shfl_xor_sync(kFull, a, off);
            b += __shfl_xor_sync(kFull, b, off);
          }
          if (src >= 0 && q == 0) {
            const float coef = p.scale * (dd * a - 2.f * ff * b) / rr;
            const float gx = coef * ex, gy = coef * ey, gz = coef * ez;
            const int lc = base + src;
            grow[lc] = gx;
            grow[p.lanes + lc] = gy;
            grow[2 * p.lanes + lc] = gz;
            cgx += gx;
            cgy += gy;
            cgz += gz;
          }
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      cgx += __shfl_xor_sync(kFull, cgx, off);
      cgy += __shfl_xor_sync(kFull, cgy, off);
      cgz += __shfl_xor_sync(kFull, cgz, off);
    }
    if (lane == 0) {
      dctr[crow * 3] = -cgx;
      dctr[crow * 3 + 1] = -cgy;
      dctr[crow * 3 + 2] = -cgz;
    }
  }
  __syncthreads();
  const size_t plane = (size_t)p.ncl * p.lanes;
  const size_t base = (size_t)i * p.lanes;
  for (int l = threadIdx.x; l < 3 * p.lanes; l += kThreads) {
    const int comp = l / p.lanes, lc = l - comp * p.lanes;
    float s = 0.f;
    for (int r = 0; r < p.cl; ++r) s += gl[(size_t)(r * 3 + comp) * p.lanes + lc];
    dj[comp * plane + base + lc] = s;
  }
}

// The lane geometry comes from the wrapper (cuda_cluster.py, whose plain
// version uses the same bounds); it is checked here: the species blocks
// tile [0, lanes) and every row's self lane lies inside the block at
// self_off.
int make_params(ClusterParams& p, int ncl, int cl, int lanes, int npres,
                const int* lane_lo, const int* lane_hi, int self_off, int n_r,
                const float* eta, const float* rs, double rc, double scale) {
  if (cl < 1 || cl > kWarps || npres < 1 || npres > kMaxSpecies || n_r < 1 ||
      n_r > kMaxRadial || lanes < 1 || lane_lo[0] != 0 ||
      lane_hi[npres - 1] != lanes)
    return (int)cudaErrorInvalidValue;
  bool self_in = false;
  for (int s = 0; s < npres; ++s) {
    if (lane_hi[s] < lane_lo[s] || (s > 0 && lane_lo[s] != lane_hi[s - 1]))
      return (int)cudaErrorInvalidValue;
    if (self_off == lane_lo[s] && self_off + cl <= lane_hi[s]) self_in = true;
  }
  if (!self_in) return (int)cudaErrorInvalidValue;
  p.ncl = ncl;
  p.cl = cl;
  p.lanes = lanes;
  p.npres = npres;
  p.n_r = n_r;
  p.r_pad = 1;
  while (p.r_pad < n_r) p.r_pad <<= 1;
  p.groups = 32 / p.r_pad;
  p.out_w = npres * n_r;
  p.self_off = self_off;
  p.rc = (float)rc;
  p.rc2 = (float)(rc * rc);
  p.pi_rc = (float)(3.14159265358979323846 / rc);
  p.scale = (float)scale;
  for (int s = 0; s < kMaxSpecies; ++s) {
    p.lane_lo[s] = s < npres ? lane_lo[s] : lanes;
    p.lane_hi[s] = s < npres ? lane_hi[s] : lanes;
  }
  for (int k = 0; k < kMaxRadial; ++k) {
    p.eta[k] = k < n_r ? eta[k] : 0.f;
    p.rs[k] = k < n_r ? rs[k] : 0.f;
  }
  return 0;
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
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
  const size_t smem = 3 * (size_t)lanes * sizeof(float);
  cudaError_t err = prepare(cluster_radial_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cluster_radial_fwd_kernel<<<ncl, kThreads, smem, (cudaStream_t)stream>>>(
      jx, jy, jz, centers, out, p);
  return (int)cudaGetLastError();
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
  const size_t smem = 3 * (size_t)lanes * (1 + cl) * sizeof(float);
  cudaError_t err = prepare(cluster_radial_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cluster_radial_bwd_kernel<<<ncl, kThreads, smem, (cudaStream_t)stream>>>(
      jx, jy, jz, centers, g, dj, dctr, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
