// Angular AEV over species-blocked neighbor lanes, forward and backward,
// for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_aev.py:76
// make_angular_kernel: fwd_kernel (:405) / fwd_kernel_rad (:409) and
// bwd_kernel (:557) / bwd_kernel_rad (:565), with pow_impl='split',
// fc_impl='poly'. Wrapper, autograd Function and plain PyTorch version:
// nnpops_tpu_torch/ops/cuda_aev.py.
//
// What bounds it on the H100: FP32 ALU and SFU throughput. Each triple
// (j, k) costs one sqrt, n_ts (log, exp) pairs for the fractional power,
// n_rs exps for the Gaussians and n_rs * n_ts FMAs; the backward adds a
// second power per theta and the cotangent chain. The bytes are small
// (a row's <= Kat lanes of three coordinate planes in, n_seg * A floats out).
//
// What the simple design does about it: one thread block per atom row.
// Everything that depends on one lane only (coordinates after the mask
// push, clamped r, fc and the r < ra test) is computed once per lane into
// shared memory, so the per-triple work is the pair geometry, the powers
// and the exps. Threads stride over the row's static triples segment by
// segment; the forward keeps the n_rs * n_ts sums of a segment in
// registers and reduces them across the block with warp shuffles (fixed
// order, deterministic). The backward recomputes the geometry (nothing is
// saved between the passes), accumulates per-lane cotangents with
// shared-memory atomics and writes each output lane once: no global
// atomics. On the GPU a triple is two index loads; the TPU kernel's
// selection matmuls have no counterpart here.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 16;

struct AngParams {
  int n_rows, width, kat, n_seg;
  float ra, far, inv_ra2, two_inv_ra2, neg_eta, zeta;
  int zi, zi1;          // integer parts of zeta and zeta - 1
  float zf, zf1;        // fractional parts
  int has_zf, has_zf1;  // fractional part above 1e-12
  int torchani;
  float rs[kMaxGrid], cts[kMaxGrid], sts[kMaxGrid];
};

// fc(t), t = (r/ra)^2: Horner chain of the degree-8 fit (FC_COEFFS in
// cuda_aev.py), coefficients rounded to f32 as in the reference.
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

// base^(zi + zf): binary exponentiation for the integer part, exp(zf log)
// only for the fractional part (a plain powf of 14.1 amplifies log's error
// about 14x).
__device__ __forceinline__ float pow_split(float base, int zi, float zf,
                                           int has_zf) {
  float result = 1.f;
  bool have = false;
  float sq = base;
  int k = zi;
  while (k) {
    if (k & 1) {
      result = have ? result * sq : sq;
      have = true;
    }
    k >>= 1;
    if (k) sq = sq * sq;
  }
  if (has_zf) {
    const float frac = expf(zf * logf(base));
    result = have ? result * frac : frac;
  }
  return result;
}

struct Lanes {
  float *x, *y, *z, *r, *fc, *valid;
};

__device__ __forceinline__ Lanes carve_lanes(float* smem, int kat) {
  return Lanes{smem, smem + kat, smem + 2 * kat, smem + 3 * kat,
               smem + 4 * kat, smem + 5 * kat};
}

// Per-lane quantities of one row: masked lanes move `far` away in x so they
// fail r < ra on their own; r is clamped to >= 1e-3 before any reciprocal.
__device__ void stage_lanes(const float* __restrict__ planes,
                            const uint8_t* __restrict__ mask,
                            const int* __restrict__ lane_pos, int row,
                            const AngParams& p, Lanes L) {
  const size_t plane = (size_t)p.n_rows * p.width;
  for (int l = threadIdx.x; l < p.kat; l += kThreads) {
    const size_t at = (size_t)row * p.width + lane_pos[l];
    const float m = mask[(size_t)row * p.kat + l] ? 1.f : 0.f;
    const float x = planes[at] + (1.f - m) * p.far;
    const float y = planes[plane + at];
    const float z = planes[2 * plane + at];
    float r = sqrtf(x * x + y * y + z * z);
    const bool valid = r < p.ra;
    r = fmaxf(r, 1e-3f);
    const float t = fminf(r * r * p.inv_ra2, 1.f);
    L.x[l] = x;
    L.y[l] = y;
    L.z[l] = z;
    L.r[l] = r;
    L.fc[l] = valid ? fc_poly_t(t) : 0.f;
    L.valid[l] = valid ? 1.f : 0.f;
  }
}

struct Triple {
  float x1, y1, z1, x2, y2, z2, r1, r2, fc1, fc2;
  float inv12, cos_t, sin_t, rm, vf;
  float cx, cy, cz;   // cross product (publication mode only)
};

__device__ __forceinline__ Triple triple_geometry(const Lanes& L, int j,
                                                  int k, const AngParams& p) {
  Triple t;
  t.x1 = L.x[j]; t.y1 = L.y[j]; t.z1 = L.z[j];
  t.x2 = L.x[k]; t.y2 = L.y[k]; t.z2 = L.z[k];
  t.r1 = L.r[j]; t.r2 = L.r[k];
  t.fc1 = L.fc[j]; t.fc2 = L.fc[k];
  const float dot12 = t.x1 * t.x2 + t.y1 * t.y2 + t.z1 * t.z2;
  t.inv12 = 1.f / (t.r1 * t.r2);
  if (p.torchani) {
    // torchani 0.95 dot scale and clip.
    t.cos_t = fminf(fmaxf(0.95f * dot12 * t.inv12, -0.95f), 0.95f);
    t.sin_t = sqrtf(1.f - t.cos_t * t.cos_t);
    t.cx = t.cy = t.cz = 0.f;
  } else {
    t.cos_t = fminf(fmaxf(dot12 * t.inv12, -1.f), 1.f);
    t.cx = t.y1 * t.z2 - t.z1 * t.y2;
    t.cy = t.z1 * t.x2 - t.x1 * t.z2;
    t.cz = t.x1 * t.y2 - t.y1 * t.x2;
    t.sin_t = sqrtf(fmaxf(t.cx * t.cx + t.cy * t.cy + t.cz * t.cz, 1e-12f))
              * t.inv12;
  }
  t.rm = 0.5f * (t.r1 + t.r2);
  t.vf = t.fc1 * t.fc2;
  return t;
}

template <int NRS, int NTS>
__global__ void __launch_bounds__(kThreads)
angular_fwd_kernel(const float* __restrict__ planes,
                   const uint8_t* __restrict__ mask,
                   const int* __restrict__ lane_pos,
                   const int* __restrict__ jj, const int* __restrict__ kk,
                   const int* __restrict__ seg_bounds,
                   float* __restrict__ out, const AngParams p) {
  constexpr int NA = NRS * NTS;
  extern __shared__ float smem[];
  const Lanes L = carve_lanes(smem, p.kat);
  float* red = smem + 6 * p.kat;                 // [kWarps][NA]
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_lanes(planes, mask, lane_pos, row, p, L);
  __syncthreads();

  for (int s = 0; s < p.n_seg; ++s) {
    float acc[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = 0.f;
    const int t_end = seg_bounds[s + 1];
    for (int t = seg_bounds[s] + threadIdx.x; t < t_end; t += kThreads) {
      const int j = jj[t], k = kk[t];
      if (L.valid[j] == 0.f || L.valid[k] == 0.f) continue;
      const Triple tr = triple_geometry(L, j, k, p);
      float P[NTS];
#pragma unroll
      for (int ts = 0; ts < NTS; ++ts) {
        const float base =
            fmaxf(1.f + (tr.cos_t * p.cts[ts] + tr.sin_t * p.sts[ts]), 1e-20f);
        P[ts] = pow_split(base, p.zi, p.zf, p.has_zf);
      }
#pragma unroll
      for (int rs = 0; rs < NRS; ++rs) {
        const float u = tr.rm - p.rs[rs];
        const float e = tr.vf * expf(p.neg_eta * (u * u));
#pragma unroll
        for (int ts = 0; ts < NTS; ++ts) acc[rs * NTS + ts] += e * P[ts];
      }
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      float v = acc[a];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp * NA + a] = v;
    }
    __syncthreads();
    for (int a = threadIdx.x; a < NA; a += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * NA + a];
      out[(size_t)row * p.n_seg * NA + s * NA + a] = v;
    }
    __syncthreads();
  }
}

template <int NRS, int NTS>
__global__ void __launch_bounds__(kThreads)
angular_bwd_kernel(const float* __restrict__ planes,
                   const uint8_t* __restrict__ mask,
                   const int* __restrict__ lane_pos,
                   const int* __restrict__ col_lane,
                   const int* __restrict__ jj, const int* __restrict__ kk,
                   const int* __restrict__ seg_bounds,
                   const float* __restrict__ g, float* __restrict__ out,
                   const AngParams p) {
  constexpr int NA = NRS * NTS;
  extern __shared__ float smem[];
  const Lanes L = carve_lanes(smem, p.kat);
  float* gx = smem + 6 * p.kat;
  float* gy = gx + p.kat;
  float* gz = gy + p.kat;
  float* gs = gz + p.kat;                        // [n_seg * NA] cotangents
  const int row = blockIdx.x;
  stage_lanes(planes, mask, lane_pos, row, p, L);
  for (int l = threadIdx.x; l < p.kat; l += kThreads) {
    gx[l] = 0.f;
    gy[l] = 0.f;
    gz[l] = 0.f;
  }
  for (int a = threadIdx.x; a < p.n_seg * NA; a += kThreads)
    gs[a] = g[(size_t)row * p.n_seg * NA + a];
  __syncthreads();

  for (int s = 0; s < p.n_seg; ++s) {
    const float* G = gs + s * NA;
    const int t_end = seg_bounds[s + 1];
    for (int t = seg_bounds[s] + threadIdx.x; t < t_end; t += kThreads) {
      const int j = jj[t], k = kk[t];
      if (L.valid[j] == 0.f || L.valid[k] == 0.f) continue;
      const Triple tr = triple_geometry(L, j, k, p);
      float P[NTS], Pm1[NTS], E[NRS], U[NRS];
#pragma unroll
      for (int ts = 0; ts < NTS; ++ts) {
        const float base =
            fmaxf(1.f + (tr.cos_t * p.cts[ts] + tr.sin_t * p.sts[ts]), 1e-20f);
        P[ts] = pow_split(base, p.zi, p.zf, p.has_zf);
        Pm1[ts] = pow_split(base, p.zi1, p.zf1, p.has_zf1);
      }
#pragma unroll
      for (int rs = 0; rs < NRS; ++rs) {
        U[rs] = tr.rm - p.rs[rs];
        E[rs] = expf(p.neg_eta * (U[rs] * U[rs]));
      }
      // Term W = vf * E_rs * P_ts, so with cotangents G:
      //   dvf = sum G E P;  drm = vf sum G P dE/drm;  dP_ts = vf sum_rs G E.
      float c_acc[NTS];
#pragma unroll
      for (int ts = 0; ts < NTS; ++ts) c_acc[ts] = 0.f;
      float dvf = 0.f, drm_raw = 0.f;
#pragma unroll
      for (int rs = 0; rs < NRS; ++rs) {
        float p_rs = 0.f;
#pragma unroll
        for (int ts = 0; ts < NTS; ++ts) {
          const float gv = G[rs * NTS + ts];
          p_rs += gv * P[ts];
          c_acc[ts] += gv * E[rs];
        }
        const float t_rs = E[rs] * p_rs;
        dvf += t_rs;
        drm_raw += t_rs * U[rs];
      }
      const float drm = tr.vf * (-2.f * -p.neg_eta) * drm_raw;
      float dcos = 0.f, dsin = 0.f;
#pragma unroll
      for (int ts = 0; ts < NTS; ++ts) {
        const float dctm = tr.vf * c_acc[ts] * p.zeta * Pm1[ts];
        dcos += dctm * p.cts[ts];
        dsin += dctm * p.sts[ts];
      }
      const float dfc1 = dfc_poly_t(fminf(tr.r1 * tr.r1 * p.inv_ra2, 1.f))
                         * p.two_inv_ra2 * tr.r1;
      const float dfc2 = dfc_poly_t(fminf(tr.r2 * tr.r2 * p.inv_ra2, 1.f))
                         * p.two_inv_ra2 * tr.r2;
      float dr1 = 0.5f * drm + dvf * dfc1 * tr.fc2;
      float dr2 = 0.5f * drm + dvf * tr.fc1 * dfc2;
      float ddot;
      float c1x = 0.f, c1y = 0.f, c1z = 0.f, c2x = 0.f, c2y = 0.f, c2z = 0.f;
      if (p.torchani) {
        // sin = sqrt(1 - cos^2), cos = 0.95 dot / (r1 r2) (clip interior).
        const float dcos_eff = dcos - dsin * tr.cos_t / tr.sin_t;
        ddot = 0.95f * tr.inv12 * dcos_eff;
        dr1 = dr1 - tr.cos_t / tr.r1 * dcos_eff;
        dr2 = dr2 - tr.cos_t / tr.r2 * dcos_eff;
      } else {
        // cos = dot / (r1 r2), sin = |d1 x d2| / (r1 r2).
        ddot = tr.inv12 * dcos;
        dr1 = dr1 - tr.cos_t / tr.r1 * dcos - tr.sin_t / tr.r1 * dsin;
        dr2 = dr2 - tr.cos_t / tr.r2 * dcos - tr.sin_t / tr.r2 * dsin;
        const float cnorm = sqrtf(
            fmaxf(tr.cx * tr.cx + tr.cy * tr.cy + tr.cz * tr.cz, 1e-12f));
        const float sc = dsin * tr.inv12 / cnorm;
        c1x = sc * (tr.y2 * tr.cz - tr.z2 * tr.cy);
        c1y = sc * (tr.z2 * tr.cx - tr.x2 * tr.cz);
        c1z = sc * (tr.x2 * tr.cy - tr.y2 * tr.cx);
        c2x = sc * (tr.cy * tr.z1 - tr.cz * tr.y1);
        c2y = sc * (tr.cz * tr.x1 - tr.cx * tr.z1);
        c2z = sc * (tr.cx * tr.y1 - tr.cy * tr.x1);
      }
      const float inv_r1 = 1.f / tr.r1, inv_r2 = 1.f / tr.r2;
      atomicAdd(&gx[j], ddot * tr.x2 + dr1 * tr.x1 * inv_r1 + c1x);
      atomicAdd(&gy[j], ddot * tr.y2 + dr1 * tr.y1 * inv_r1 + c1y);
      atomicAdd(&gz[j], ddot * tr.z2 + dr1 * tr.z1 * inv_r1 + c1z);
      atomicAdd(&gx[k], ddot * tr.x1 + dr2 * tr.x2 * inv_r2 + c2x);
      atomicAdd(&gy[k], ddot * tr.y1 + dr2 * tr.y2 * inv_r2 + c2y);
      atomicAdd(&gz[k], ddot * tr.z1 + dr2 * tr.z2 * inv_r2 + c2z);
    }
  }
  __syncthreads();
  // Every column of the row is written once: the lane's cotangent where an
  // angular lane sits, zero elsewhere (radial-only lanes).
  const size_t plane = (size_t)p.n_rows * p.width;
  for (int col = threadIdx.x; col < p.width; col += kThreads) {
    const int l = col_lane[col];
    const size_t at = (size_t)row * p.width + col;
    out[at] = l >= 0 ? gx[l] : 0.f;
    out[plane + at] = l >= 0 ? gy[l] : 0.f;
    out[2 * plane + at] = l >= 0 ? gz[l] : 0.f;
  }
}

AngParams make_params(int n_rows, int width, int kat, int n_seg, int n_rs,
                      int n_ts, const float* rs, const float* cts,
                      const float* sts, double ra, double eta, double zeta,
                      int torchani) {
  AngParams p;
  p.n_rows = n_rows;
  p.width = width;
  p.kat = kat;
  p.n_seg = n_seg;
  // Derived constants in double, rounded once to f32 (the reference's
  // Python-float constants).
  p.ra = (float)ra;
  p.far = (float)(4.0 * ra);
  p.inv_ra2 = (float)(1.0 / (ra * ra));
  p.two_inv_ra2 = (float)(2.0 * (1.0 / (ra * ra)));
  p.neg_eta = (float)(-eta);
  p.zeta = (float)zeta;
  p.zi = (int)std::floor(zeta);
  p.zf = (float)(zeta - p.zi);
  p.has_zf = (zeta - p.zi) > 1e-12;
  const double zeta1 = zeta - 1.0;
  p.zi1 = (int)std::floor(zeta1);
  p.zf1 = (float)(zeta1 - p.zi1);
  p.has_zf1 = (zeta1 - p.zi1) > 1e-12;
  p.torchani = torchani;
  for (int i = 0; i < kMaxGrid; ++i) {
    p.rs[i] = i < n_rs ? rs[i] : 0.f;
    p.cts[i] = i < n_ts ? cts[i] : 0.f;
    p.sts[i] = i < n_ts ? sts[i] : 0.f;
  }
  return p;
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

template <int NRS, int NTS>
int launch_fwd(const float* planes, const uint8_t* mask, const int* lane_pos,
               const int* jj, const int* kk, const int* seg_bounds, float* out,
               const AngParams& p, cudaStream_t stream) {
  const size_t smem = (6 * (size_t)p.kat + kWarps * NRS * NTS) * sizeof(float);
  cudaError_t err = prepare(angular_fwd_kernel<NRS, NTS>, smem);
  if (err != cudaSuccess) return (int)err;
  angular_fwd_kernel<NRS, NTS><<<p.n_rows, kThreads, smem, stream>>>(
      planes, mask, lane_pos, jj, kk, seg_bounds, out, p);
  return (int)cudaGetLastError();
}

template <int NRS, int NTS>
int launch_bwd(const float* planes, const uint8_t* mask, const int* lane_pos,
               const int* col_lane, const int* jj, const int* kk,
               const int* seg_bounds, const float* g, float* out,
               const AngParams& p, cudaStream_t stream) {
  const size_t smem =
      (9 * (size_t)p.kat + (size_t)p.n_seg * NRS * NTS) * sizeof(float);
  cudaError_t err = prepare(angular_bwd_kernel<NRS, NTS>, smem);
  if (err != cudaSuccess) return (int)err;
  angular_bwd_kernel<NRS, NTS><<<p.n_rows, kThreads, smem, stream>>>(
      planes, mask, lane_pos, col_lane, jj, kk, seg_bounds, g, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nnpops_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int angular_aev_fwd(const float* planes, const uint8_t* mask,
                    const int* lane_pos, const int* jj, const int* kk,
                    const int* seg_bounds, float* out, int n_rows, int width,
                    int kat, int n_seg, int n_rs, int n_ts, const float* rs,
                    const float* cts, const float* sts, double ra, double eta,
                    double zeta, int torchani, void* stream) {
  if (n_rows <= 0) return 0;
  const AngParams p = make_params(n_rows, width, kat, n_seg, n_rs, n_ts, rs,
                                  cts, sts, ra, eta, zeta, torchani);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rs == 8 && n_ts == 4)
    return launch_fwd<8, 4>(planes, mask, lane_pos, jj, kk, seg_bounds, out, p, st);
  if (n_rs == 3 && n_ts == 3)
    return launch_fwd<3, 3>(planes, mask, lane_pos, jj, kk, seg_bounds, out, p, st);
  return (int)cudaErrorInvalidValue;
}

int angular_aev_bwd(const float* planes, const uint8_t* mask,
                    const int* lane_pos, const int* col_lane, const int* jj,
                    const int* kk, const int* seg_bounds, const float* g,
                    float* out, int n_rows, int width, int kat, int n_seg,
                    int n_rs, int n_ts, const float* rs, const float* cts,
                    const float* sts, double ra, double eta, double zeta,
                    int torchani, void* stream) {
  if (n_rows <= 0) return 0;
  const AngParams p = make_params(n_rows, width, kat, n_seg, n_rs, n_ts, rs,
                                  cts, sts, ra, eta, zeta, torchani);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rs == 8 && n_ts == 4)
    return launch_bwd<8, 4>(planes, mask, lane_pos, col_lane, jj, kk,
                            seg_bounds, g, out, p, st);
  if (n_rs == 3 && n_ts == 3)
    return launch_bwd<3, 3>(planes, mask, lane_pos, col_lane, jj, kk,
                            seg_bounds, g, out, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
