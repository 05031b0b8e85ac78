// Window radial AEV, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_window.py:155
// make_window_radial_kernel: fwd_kernel (pallas_call at :361) and
// bwd_kernel (:378), with fc_impl='poly' and center_caps (cell-occupancy
// bucketing). Wrapper, autograd Function and plain PyTorch version:
// nnpops_tpu_torch/ops/cuda_window.py (its docstring states the contract).
//
// What bounds it on the H100: FP32 and SFU operations. Every (center,
// candidate lane) pair costs a distance test (about 7 operations); a valid
// pair (d2 < rc^2, ~10 % of the window's lanes at water density) costs a
// sqrt, the degree-8 fc polynomial and R = 16 Gaussians, about 120
// operations forward, and the backward adds the cotangent sums per
// Gaussian and the chain to the three deltas. The bytes are small: the
// cell's 27-cell window (3 x kk floats, 10 KB at kk = 864) and its centers
// in, c_ctr x P*R floats out.
//
// Design: one block of 8 warps per (cell, group of 8 center rows), a warp
// per center row. The block stages the cell's window in shared memory.
// A warp walks its species blocks 32 lanes at a time: each lane tests its
// own candidate, __ballot_sync collects the valid ones, and the valid
// pairs are then processed 32 / R_pad at a time with one lane per
// Gaussian (R_pad = R rounded up to a power of two), so exps are spent on
// valid pairs only and no lane idles on an invalid one. The forward keeps
// one running sum per lane and reduces the pair groups with shuffles at
// the end of a species block (fixed order: deterministic). The backward
// recomputes the geometry, reduces A = sum_q g_q e_q and
// B = sum_q g_q e_q eta_q u_q across a group's lanes, and the group's
// first lane forms alpha = dfc A - 2 fc B and the three delta cotangents:
// the center's are summed in registers and reduced over the warp, the
// candidates' go into shared-memory sums (atomics) that the block adds
// once per lane into the zeroed global planes (atomics: the row groups of
// a cell are separate blocks). Centers at or beyond FAR/2 are empty slots:
// their rows are 0 and evaluate no pair.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSpecies = 8;
constexpr int kMaxRadial = 32;
constexpr float kEmptyRow = 0.5e6f;     // FAR / 2
constexpr unsigned kFull = 0xffffffffu;

struct WinParams {
  int ncells, kk, c_ctr, npres, n_r, r_pad, groups, out_w;
  float rc, rc2, inv_rc2, two_inv_rc2, scale;
  int lane_lo[kMaxSpecies], lane_hi[kMaxSpecies];  // species lane blocks
  int ctr_off[kMaxSpecies + 1];                    // packed center rows
  int self_shift[kMaxSpecies];   // self lane = row + self_shift[species]
  float eta[kMaxRadial], rs[kMaxRadial];
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

__device__ __forceinline__ void stage_window(const float* __restrict__ cx,
                                             const float* __restrict__ cy,
                                             const float* __restrict__ cz,
                                             int cell, int kk, float* sx,
                                             float* sy, float* sz) {
  const size_t base = (size_t)cell * kk;
  for (int l = threadIdx.x; l < kk; l += kThreads) {
    sx[l] = cx[base + l];
    sy[l] = cy[base + l];
    sz[l] = cz[base + l];
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

__device__ __forceinline__ int self_lane_of(int row, const WinParams& p) {
  int s_row = 0;
  for (int s = 1; s < p.npres; ++s)
    if (row >= p.ctr_off[s]) s_row = s;
  return row + p.self_shift[s_row];
}

__global__ void __launch_bounds__(kThreads)
window_radial_fwd_kernel(const float* __restrict__ cx,
                         const float* __restrict__ cy,
                         const float* __restrict__ cz,
                         const float* __restrict__ centers,
                         float* __restrict__ out, const WinParams p) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + p.kk;
  float* sz = sy + p.kk;
  const int cell = blockIdx.x;
  stage_window(cx, cy, cz, cell, p.kk, sx, sy, sz);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.y * kWarps + warp;
  if (row >= p.c_ctr) return;                    // whole warp leaves
  const size_t crow = (size_t)cell * p.c_ctr + row;
  const float px = centers[crow * 3], py = centers[crow * 3 + 1],
              pz = centers[crow * 3 + 2];
  const bool empty = px >= kEmptyRow;
  const int self_lane = self_lane_of(row, p);
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
          fc = fc_poly_t(fminf(d2 * p.inv_rc2, 1.f));
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
window_radial_bwd_kernel(const float* __restrict__ cx,
                         const float* __restrict__ cy,
                         const float* __restrict__ cz,
                         const float* __restrict__ centers,
                         const float* __restrict__ g,
                         float* __restrict__ dcand,
                         float* __restrict__ dctr, const WinParams p) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + p.kk;
  float* sz = sy + p.kk;
  float* ax = sz + p.kk;                         // candidate cotangent sums
  float* ay = ax + p.kk;
  float* az = ay + p.kk;
  const int cell = blockIdx.x;
  stage_window(cx, cy, cz, cell, p.kk, sx, sy, sz);
  for (int l = threadIdx.x; l < p.kk; l += kThreads) {
    ax[l] = 0.f;
    ay[l] = 0.f;
    az[l] = 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.y * kWarps + warp;
  if (row < p.c_ctr) {
    const size_t crow = (size_t)cell * p.c_ctr + row;
    const float px = centers[crow * 3], py = centers[crow * 3 + 1],
                pz = centers[crow * 3 + 2];
    const bool empty = px >= kEmptyRow;
    const int self_lane = self_lane_of(row, p);
    const int q = lane & (p.r_pad - 1), grp = lane / p.r_pad;
    const bool q_on = q < p.n_r;
    const float eta_q = q_on ? p.eta[q] : 0.f, rs_q = q_on ? p.rs[q] : 0.f;
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
            const float t = fminf(d2 * p.inv_rc2, 1.f);
            fc = fc_poly_t(t);
            dfc = dfc_poly_t(t) * (p.two_inv_rc2 * r);
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
            atomicAdd(&ax[lc], gx);
            atomicAdd(&ay[lc], gy);
            atomicAdd(&az[lc], gz);
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
  const size_t plane = (size_t)p.ncells * p.kk;
  const size_t base = (size_t)cell * p.kk;
  for (int l = threadIdx.x; l < p.kk; l += kThreads) {
    if (ax[l] != 0.f) atomicAdd(&dcand[base + l], ax[l]);
    if (ay[l] != 0.f) atomicAdd(&dcand[plane + base + l], ay[l]);
    if (az[l] != 0.f) atomicAdd(&dcand[2 * plane + base + l], az[l]);
  }
}

// The lane geometry comes from the wrapper (WindowGeometry in
// cuda_window.py, which the plain version uses too); it is checked here:
// species lane blocks tile [0, kk), packed center rows ascend, and every
// center row's self lane lies inside its species' block.
int make_params(WinParams& p, int ncells, int npres, int kk,
                const int* lane_lo, const int* lane_hi, const int* ctr_off,
                const int* self_shift, int n_r, const float* eta,
                const float* rs, double rc, double scale) {
  if (npres < 1 || npres > kMaxSpecies || n_r < 1 || n_r > kMaxRadial ||
      kk < 1 || lane_lo[0] != 0 || lane_hi[npres - 1] != kk || ctr_off[0] != 0)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < npres; ++s) {
    const int rows = ctr_off[s + 1] - ctr_off[s];
    if (lane_hi[s] < lane_lo[s] || (s > 0 && lane_lo[s] != lane_hi[s - 1]) ||
        rows < 0)
      return (int)cudaErrorInvalidValue;
    if (rows > 0 && (ctr_off[s] + self_shift[s] < lane_lo[s] ||
                     ctr_off[s + 1] - 1 + self_shift[s] >= lane_hi[s]))
      return (int)cudaErrorInvalidValue;
  }
  p.ncells = ncells;
  p.npres = npres;
  p.n_r = n_r;
  p.r_pad = 1;
  while (p.r_pad < n_r) p.r_pad <<= 1;
  p.groups = 32 / p.r_pad;
  p.out_w = npres * n_r;
  p.rc = (float)rc;
  p.rc2 = (float)(rc * rc);
  p.inv_rc2 = (float)(1.0 / (rc * rc));
  p.two_inv_rc2 = (float)(2.0 / (rc * rc));
  p.scale = (float)scale;
  p.kk = kk;
  p.c_ctr = ctr_off[npres];
  for (int s = 0; s < kMaxSpecies; ++s) {
    const bool on = s < npres;
    p.lane_lo[s] = on ? lane_lo[s] : kk;
    p.lane_hi[s] = on ? lane_hi[s] : kk;
    p.ctr_off[s] = on ? ctr_off[s] : p.c_ctr;
    p.self_shift[s] = on ? self_shift[s] : 0;
  }
  p.ctr_off[kMaxSpecies] = p.c_ctr;
  for (int i = 0; i < kMaxRadial; ++i) {
    p.eta[i] = i < n_r ? eta[i] : 0.f;
    p.rs[i] = i < n_r ? rs[i] : 0.f;
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

int window_radial_fwd(const float* cx, const float* cy, const float* cz,
                      const float* centers, float* out, int ncells, int npres,
                      int kk, const int* lane_lo, const int* lane_hi,
                      const int* ctr_off, const int* self_shift, int n_r,
                      const float* eta, const float* rs, double rc,
                      double scale, void* stream) {
  if (ncells <= 0) return 0;
  WinParams p;
  const int bad = make_params(p, ncells, npres, kk, lane_lo, lane_hi, ctr_off,
                              self_shift, n_r, eta, rs, rc, scale);
  if (bad) return bad;
  const size_t smem = 3 * (size_t)p.kk * sizeof(float);
  cudaError_t err = prepare(window_radial_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ncells, (p.c_ctr + kWarps - 1) / kWarps);
  window_radial_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, cz, centers, out, p);
  return (int)cudaGetLastError();
}

int window_radial_bwd(const float* cx, const float* cy, const float* cz,
                      const float* centers, const float* g, float* dcand,
                      float* dctr, int ncells, int npres, int kk,
                      const int* lane_lo, const int* lane_hi,
                      const int* ctr_off, const int* self_shift, int n_r,
                      const float* eta, const float* rs, double rc,
                      double scale, void* stream) {
  if (ncells <= 0) return 0;
  WinParams p;
  const int bad = make_params(p, ncells, npres, kk, lane_lo, lane_hi, ctr_off,
                              self_shift, n_r, eta, rs, rc, scale);
  if (bad) return bad;
  const size_t smem = 6 * (size_t)p.kk * sizeof(float);
  cudaError_t err = prepare(window_radial_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ncells, (p.c_ctr + kWarps - 1) / kWarps);
  window_radial_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, cz, centers, g, dcand, dctr, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
