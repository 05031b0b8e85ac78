// PaiNN's message backward, forces only, over a symmetric full neighbor
// list, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no PaiNN. Added because the
// plain chunked backward (_rows_backward in nnpops_tpu_torch/ops/painn.py,
// whose module docstring states the contract) writes every [rows, K, 3F]
// lane tensor to device memory, a dozen passes of them, and runs over every
// lane, live or not: ~73 ms a message at 26,010 atoms, F 128, K 128.
//
// For atom row i and each live lane l (mask and d < rc), j = idx[i, l],
// with W = (rbf(d) Wf + bf) fc(d) = (W_s, W_vv, W_vs) and g_s, g_v the
// cotangents of m_s and m_v:
//   gW = phi_j * [g_s,i, sum_c g_v,i,c v_j,c, sum_c u_c g_v,i,c]
//   dd[i, l] = gW . dW/dd,   du[i, l, c] = (phi_j,vs * W_vs) . g_v,i,c
// and the row's own atom as the j of its lanes' mirrored entries (the list
// is symmetric, W_ji = W_ij, u_ji = -u_ij):
//   a_c = sum_l W_vv * g_v,j,c,
//   dphi[i] = [sum_l W_s g_s,j, sum_c v_i,c a_c, -sum_l W_vs (g_v,j . u)],
//   dv[i, c] = phi_i,vv * a_c.
// Lanes that are not live get exact zeros in dd and du (a live lane whose
// neighbor is the padding row too); a row with no live lane gets zero dphi
// and dv. No weight gradients: the MD path needs none.
//
// The cutoff is folded into the radial functions: with rbfe = (rbf fc, fc)
// and Wfe = (Wf; bf), W = rbfe Wfe and dW/dd = rbfe' Wfe, so W and its
// derivative are 2 (R + 1) FMA a feature of 3F, and W's value before the
// cutoff is never formed. The filter is computed again, not loaded.
//
// What bounds it on the H100: FFMA issue and latency. The configuration is
// true float32, so everything runs on the CUDA cores (no TF32, no bf16): 6
// (R + 1) F FMA a live pair for W and dW/dd and ~24 F more for the rest
// (16,128 + 3,072 at F 128, R 20; ~38,000 FLOP, 0.82 ms a 26k message at
// 67 TFLOP/s), against 10 F gathered floats a live pair (phi_j, v_j, g_s,j,
// g_v,j: 5 KB), which the rows walked together find in L2 (the 26k frame's
// atoms are in lattice order). On an H100 SXM at 700 W it takes ~2.2 ms a
// 26k message: without the filter's FMAs and the gathers it still takes
// ~1.1 ms (the per-lane elementwise work, the sums over features, the
// sines, the row and tile steps), so it is bound by issue and latency at
// 16 warps an SM, not by one unit. The sines are sincosf at float32
// accuracy, R + 1 a live pair.
//
// Design. A block of F threads (a thread a feature f, and its three columns
// f, F + f, 2F + f of every [3F] vector) walks atom rows blockIdx.x + m
// gridDim.x; 4 blocks an SM (128 registers). The thread holds its columns
// of Wf and bf in registers for the kernel's life (3 (R + 1) floats). A
// row's lanes are read once, in one pass that also compacts the live ones
// in lane order (ballot + popc) into shared slots (neighbor, u, d, 1/d, fc
// and fc', the lane); the rest get their zeros. Then the slots go kT = 32
// at a time: the block computes their (rbfe, rbfe') into shared memory,
// then takes the lanes kS = 4 at a time: per lane a thread reads the slot's
// constants as 16-byte broadcasts, gathers its 10 floats of the neighbor's
// rows (coalesced across the warp, one lane ahead of their use, across
// tiles too), adds the lane's terms to its five row sums (sum W_s g_s,j, a,
// sum W_vs (g_v,j . u)) in registers and keeps the lane's four sums over
// features (dd, du) as partials; after 4 lanes a transposing butterfly of
// 16 shuffles leaves each pair of the warp's threads one of the 16 warp
// sums, which go to shared memory; the tile's dd and du are then the sums
// over the block's warps, in a fixed order, written once. At the row's end
// dphi and dv are written once. No atomics: two launches on the same inputs
// are bitwise equal.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxF = 128;             // features, a thread each
constexpr int kT = 32;                 // slots a tile
constexpr int kS = 4;                  // lanes a sub-tile
constexpr int kSub = kT / kS;
constexpr int kNV = 4 * kS;            // a sub-tile's sums: dd, du (3) a lane
constexpr int kG = 10;                 // floats gathered a lane a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;

// Shared-memory carve in floats; every array starts on 16 bytes.
template <int R>
struct Carve {
  // Floats a slot's radial constants take: (rbfe_m, rbfe'_m) for m <= R,
  // padded to 16 bytes.
  static constexpr int NC = (2 * (R + 1) + 3) / 4 * 4;
  static constexpr int cst = 0,                  // [kT][NC]
      red = cst + kT * NC,                       // [warps][kSub][kNV]
      freq = red + (kMaxF / 32) * kSub * kNV,    // [R], padded
      wc = freq + (R + 3) / 4 * 4,               // [8] ints
      slots = wc + 8;                            // su, sd [K] float4, sl [K]
  __host__ __device__ static constexpr int su(int k) { return slots; }
  __host__ __device__ static constexpr int sd(int k) { return slots + 4 * k; }
  __host__ __device__ static constexpr int sl(int k) { return slots + 8 * k; }
  static constexpr int bytes(int k) { return 4 * (slots + 9 * k); }
};

// One halving step of transpose_sum: lanes with bit LB set keep the upper
// H values and add their partner's, the others the lower H.
template <int LB, int H>
__device__ __forceinline__ void halve(float (&p)[kNV], int lane) {
  const bool up = lane & LB;
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const float send = up ? p[e] : p[e + H];
    const float keep = up ? p[e + H] : p[e];
    p[e] = keep + __shfl_xor_sync(kFull, send, LB);
  }
}

// The warp's sums of the 16 values p over its 32 threads: lanes 2 v and
// 2 v + 1 hold value v's (16 shuffles, a fixed order of additions).
__device__ __forceinline__ float transpose_sum(float (&p)[kNV], int lane) {
  static_assert(kNV == 16, "16 values");
  halve<16, 8>(p, lane);
  halve<8, 4>(p, lane);
  halve<4, 2>(p, lane);
  halve<2, 1>(p, lane);
  return p[0] + __shfl_xor_sync(kFull, p[0], 1);
}

template <int R>
__global__ void __launch_bounds__(kMaxF, 4)
painn_bwd_kernel(const float* __restrict__ phi, const float* __restrict__ v,
                 const float* __restrict__ dist, const float* __restrict__ u,
                 const int64_t* __restrict__ idx,
                 const uint8_t* __restrict__ live,
                 const float* __restrict__ wf, const float* __restrict__ bf,
                 const float* __restrict__ freqs, const float* __restrict__ gs,
                 const float* __restrict__ gv, float* __restrict__ dd,
                 float* __restrict__ du, float* __restrict__ dphi,
                 float* __restrict__ dv, const int n, const int k,
                 const float half_pi_rc) {
  using C = Carve<R>;
  constexpr int NC = C::NC;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  float* cst = sm + C::cst;
  float* red = sm + C::red;
  float* freq = sm + C::freq;
  int* wc = reinterpret_cast<int*>(sm + C::wc);
  float4* su = reinterpret_cast<float4*>(sm + C::su(k));  // u, neighbor
  float4* sd = reinterpret_cast<float4*>(sm + C::sd(k));  // d, 1/d, fc, fc'
  int* sl = reinterpret_cast<int*>(sm + C::sl(k));        // lane

  const int F = blockDim.x, F3 = 3 * F, nw = F >> 5;
  const int f = threadIdx.x, warp = f >> 5, lane = f & 31;

  // This thread's columns of (Wf; bf): W_s, W_vv, W_vs = rbfe . w0, w1, w2.
  float w0[R + 1], w1[R + 1], w2[R + 1];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    w0[m] = __ldg(wf + m * F3 + f);
    w1[m] = __ldg(wf + m * F3 + F + f);
    w2[m] = __ldg(wf + m * F3 + 2 * F + f);
  }
  w0[R] = __ldg(bf + f);
  w1[R] = __ldg(bf + F + f);
  w2[R] = __ldg(bf + 2 * F + f);
  for (int m = f; m < R; m += F) freq[m] = freqs[m];
  __syncthreads();
  const float freq0 = freq[0];

  // The row's live slots; the 10 floats of slot s's neighbor row that this
  // thread reads: phi_j (3), v_j (3), g_s,j, g_v,j (3); zeros past the
  // row's slots and for a slot on the padding row.
  int count = 0;
  auto gather = [&](int s, float (&g)[kG]) {
    const int j = s < count ? __float_as_int(su[s].w) : -1;
    if (j >= 0) {
      const size_t b3 = (size_t)j * F3 + f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        g[c] = __ldg(phi + b3 + c * F);
        g[3 + c] = __ldg(v + b3 + c * F);
        g[7 + c] = __ldg(gv + b3 + c * F);
      }
      g[6] = __ldg(gs + (size_t)j * F + f);
    } else {
#pragma unroll
      for (int e = 0; e < kG; ++e) g[e] = 0.f;
    }
  };

  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const size_t rowk = (size_t)row * k;
    const float gsi = gs[(size_t)row * F + f];
    float gvi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) gvi[c] = gv[(size_t)row * F3 + c * F + f];
    __syncthreads();                   // the last row's slots are free
    // The row's lanes, read once: the live ones compacted in lane order
    // into slots (neighbor -1 on the padding row, whose slot gives zeros),
    // exact zeros in dd and du for the others.
    count = 0;
    for (int base = 0; base < k; base += F) {
      const int l = base + f;
      bool ok = false;
      int j = -1;
      float d = 1.f, ux = 0.f, uy = 0.f, uz = 0.f;
      if (l < k) {
        const size_t lk = rowk + l;
        ok = live[lk];
        const int64_t jj = idx[lk];
        d = dist[lk];
        ux = u[3 * lk];
        uy = u[3 * lk + 1];
        uz = u[3 * lk + 2];
        if (!ok) {
          dd[lk] = 0.f;
          du[3 * lk] = 0.f;
          du[3 * lk + 1] = 0.f;
          du[3 * lk + 2] = 0.f;
        }
        if (ok && jj >= 0 && jj < n) j = (int)jj;
      }
      const unsigned bal = __ballot_sync(kFull, ok);
      if (lane == 0) wc[warp] = __popc(bal);
      float4 geo = make_float4(1.f, 1.f, 0.f, 0.f);
      if (j >= 0) {
        float s1, c1;
        sincosf(freq0 * d, &s1, &c1);
        geo = make_float4(d, 1.f / d, 0.5f * c1 + 0.5f, -half_pi_rc * s1);
      } else {
        ux = uy = uz = 0.f;
      }
      __syncthreads();
      int off = count;
      for (int w = 0; w < warp; ++w) off += wc[w];
      if (ok) {
        const int s = off + __popc(bal & ((1u << lane) - 1u));
        su[s] = make_float4(ux, uy, uz, __int_as_float(j));
        sd[s] = geo;
        sl[s] = l;
      }
      for (int w = 0; w < nw; ++w) count += wc[w];
      __syncthreads();
    }

    float acc_s = 0.f, acc_vs = 0.f, a[3] = {0.f, 0.f, 0.f};
    float g[kG];
    gather(0, g);
    for (int t0 = 0; t0 < count; t0 += kT) {
      const int cnt = min(kT, count - t0);
      // The tile's rbfe_m = rbf_m fc and rbfe'_m = rbf_m' fc + rbf_m fc'
      // (m < R), rbfe_R = fc, rbfe'_R = fc', rbf_m = sin(freq_m d) / d;
      // zeros past the row's slots (and fc = 0 zeroes a padding-row slot).
      for (int e = f; e < kT * (R + 1); e += F) {
        const int q = e % kT, m = e / kT;
        float re = 0.f, rp = 0.f;
        if (q < cnt) {
          const float4 s = sd[t0 + q];
          re = s.z;
          rp = s.w;
          if (m < R) {
            float sn, cs;
            sincosf(freq[m] * s.x, &sn, &cs);
            const float rbf = sn * s.y;
            const float drbf = (freq[m] * cs - rbf) * s.y;
            re = rbf * s.z;
            rp = fmaf(drbf, s.z, rbf * s.w);
          }
        }
        *reinterpret_cast<float2*>(cst + q * NC + 2 * m) = make_float2(re, rp);
      }
      __syncthreads();

      // The lanes, kS at a time; the next slot's rows are gathered while a
      // lane's terms are computed.
      const int nsub = (cnt + kS - 1) / kS;
#pragma unroll 1
      for (int sub = 0; sub < nsub; ++sub) {
        float p[kNV];
#pragma unroll
        for (int r = 0; r < kS; ++r) {
          const int q = sub * kS + r;
          float gn[kG];
          gather(t0 + q + 1, gn);
          float4 us = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q < cnt) us = su[t0 + q];
          const float4* c4 = reinterpret_cast<const float4*>(cst + q * NC);
          float ws = 0.f, wvv = 0.f, wvs = 0.f, ps = 0.f, pvv = 0.f,
                pvs = 0.f;
#pragma unroll
          for (int m = 0; m < (R + 1) / 2; ++m) {
            const float4 c = c4[m];
            ws = fmaf(c.x, w0[2 * m], ws);
            wvv = fmaf(c.x, w1[2 * m], wvv);
            wvs = fmaf(c.x, w2[2 * m], wvs);
            ps = fmaf(c.y, w0[2 * m], ps);
            pvv = fmaf(c.y, w1[2 * m], pvv);
            pvs = fmaf(c.y, w2[2 * m], pvs);
            ws = fmaf(c.z, w0[2 * m + 1], ws);
            wvv = fmaf(c.z, w1[2 * m + 1], wvv);
            wvs = fmaf(c.z, w2[2 * m + 1], wvs);
            ps = fmaf(c.w, w0[2 * m + 1], ps);
            pvv = fmaf(c.w, w1[2 * m + 1], pvv);
            pvs = fmaf(c.w, w2[2 * m + 1], pvs);
          }
          if constexpr ((R + 1) % 2 == 1) {
            const float2 c = reinterpret_cast<const float2*>(cst + q * NC)[R];
            ws = fmaf(c.x, w0[R], ws);
            wvv = fmaf(c.x, w1[R], wvv);
            wvs = fmaf(c.x, w2[R], wvs);
            ps = fmaf(c.y, w0[R], ps);
            pvv = fmaf(c.y, w1[R], pvv);
            pvs = fmaf(c.y, w2[R], pvs);
          }
          // The lane as (i, l): gW = phi_j * [g_s,i, dx_vv, dx_vs].
          const float dxvv =
              fmaf(gvi[2], g[5], fmaf(gvi[1], g[4], gvi[0] * g[3]));
          const float dxvs =
              fmaf(us.z, gvi[2], fmaf(us.y, gvi[1], us.x * gvi[0]));
          p[4 * r] =
              fmaf(g[2] * dxvs, pvs, fmaf(g[1] * dxvv, pvv, g[0] * gsi * ps));
          const float xw = g[2] * wvs;
#pragma unroll
          for (int c = 0; c < 3; ++c) p[4 * r + 1 + c] = xw * gvi[c];
          // The row's atom as the j of the mirrored entry.
          acc_s = fmaf(ws, g[6], acc_s);
#pragma unroll
          for (int c = 0; c < 3; ++c) a[c] = fmaf(wvv, g[7 + c], a[c]);
          const float gu = fmaf(g[9], us.z, fmaf(g[8], us.y, g[7] * us.x));
          acc_vs = fmaf(wvs, gu, acc_vs);
#pragma unroll
          for (int e = 0; e < kG; ++e) g[e] = gn[e];
        }
        const float tot = transpose_sum(p, lane);
        if ((lane & 1) == 0) red[(warp * kSub + sub) * kNV + (lane >> 1)] = tot;
      }
      __syncthreads();
      // The tile's dd and du: value 4 r + c of sub-tile s is slot s kS + r's
      // dd (c = 0) or du_(c - 1), summed over the warps in order.
      for (int e = f; e < nsub * kNV; e += F) {
        const int s = e / kNV, val = e % kNV, q = s * kS + (val >> 2);
        if (q >= cnt) continue;
        float t = 0.f;
        for (int w = 0; w < nw; ++w) t += red[(w * kSub + s) * kNV + val];
        const size_t lk = rowk + sl[t0 + q];
        if ((val & 3) == 0) {
          dd[lk] = t;
        } else {
          du[3 * lk + (val & 3) - 1] = t;
        }
      }
    }

    // The row's own atom: dphi = [sum W_s g_s,j, sum_c v_i,c a_c,
    // -sum W_vs (g_v,j . u)], dv_c = phi_i,vv a_c.
    const size_t b3 = (size_t)row * F3 + f;
    const float phvv = phi[b3 + F];
    float tvv = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tvv = fmaf(v[b3 + c * F], a[c], tvv);
      dv[b3 + c * F] = phvv * a[c];
    }
    dphi[b3] = acc_s;
    dphi[b3 + F] = tvv;
    dphi[b3 + 2 * F] = -acc_vs;
  }
}

template <int R>
int launch(const float* phi, const float* v, const float* dist,
           const float* u, const int64_t* idx, const uint8_t* live,
           const float* wf, const float* bf, const float* freqs,
           const float* gs, const float* gv, float* dd, float* du,
           float* dphi, float* dv, int n, int k, int width, float half_pi_rc,
           cudaStream_t stream) {
  const int smem = Carve<R>::bytes(k);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const auto kernel = painn_bwd_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, width,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)sms * (per_sm > 0 ? per_sm : 1);
  const int nblocks = (int)(blocks < n ? blocks : n);
  kernel<<<nblocks, width, smem, stream>>>(phi, v, dist, u, idx, live, wf, bf,
                                           freqs, gs, gv, dd, du, dphi, dv, n,
                                           k, half_pi_rc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// phi [n + 1, 3 width] and v [n + 1, 3 width] f32 (each ending in a zero
// row), dist [n, k] f32, u [n, k, 3] f32, idx [n, k] i64 (n = padding), live
// [n, k] u8, wf [r, 3 width], bf [3 width], freqs [r] (n pi / rc, n = 1 ..
// r), gs [n, width], gv [n, 3 width] f32. Outputs: dd [n, k], du [n, k, 3],
// dphi [n, 3 width], dv [n, 3 width] f32, every element written. width a
// multiple of 32 up to 128; r 20 (the published PaiNN's radial count).
int painn_bwd(const float* phi, const float* v, const float* dist,
              const float* u, const int64_t* idx, const uint8_t* live,
              const float* wf, const float* bf, const float* freqs,
              const float* gs, const float* gv, float* dd, float* du,
              float* dphi, float* dv, int n, int k, int width, int r,
              double half_pi_rc, void* stream) {
  if (n < 1 || k < 1 || width < 32 || width > kMaxF || width % 32 || r != 20)
    return (int)cudaErrorInvalidValue;
  return launch<20>(phi, v, dist, u, idx, live, wf, bf, freqs, gs, gv, dd, du,
                    dphi, dv, n, k, width, (float)half_pi_rc,
                    (cudaStream_t)stream);
}

}  // extern "C"
