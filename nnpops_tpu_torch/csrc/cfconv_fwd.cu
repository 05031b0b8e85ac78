// CFConv forward over a directed per-atom neighbor list, for sm_90a.
//
// Replaces no TPU kernel: the JAX package left this forward to XLA
// (nnpops_tpu/ops/cfconv.py _fwd_rows; ops/pallas_cfconv.py holds only the
// backward). Added because the plain chunked forward (conv_fwd_plain in
// nnpops_tpu_torch/ops/cuda_cfconv.py, whose docstring states the contract)
// writes every [rows, K, W] step of the filter to device memory and runs its
// two products over every lane, masked or not.
//
// For atom row i and lane l with mask[i, l], j = idx[i, l], d = dist[i, l]:
//   gauss_g = exp(-((d - c_g) / gw)^2 / 2), h = gauss w1 + b1,
//   act = ssp(h) or tanh(h), y1 = act w2 + b2, fc = 0.5 cos(pi d / rc) + 0.5,
//   out[i] = sum_l (y1 fc) * x[j].
// Masked lanes are skipped, not computed; a row with none gets zeros.
//
// What bounds it on the H100: FFMA. The configuration runs the forward in
// true float32, so both filter products are fused multiply-adds on the
// CUDA cores, not the tensor cores: G W + W^2 of them a valid pair (22,784
// at W = 128, G = 50; 45,568 FLOP at 67 TFLOP/s), against about 0.5 KB of
// gathered row and nothing written but out [N, W]. On an H100 SXM at 700
// W it takes ~13.6 ms on a 26,010-atom layer (10.9 M pairs), 54 % of that
// bound: shared-memory reads, the tile's elementwise stages and the last
// tile of each row (7 % empty slots) take the rest.
//
// Design. One persistent block of 8 warps per SM walks atom rows in two
// streams (stream s: rows blockIdx.x + (2 m + s) gridDim.x). It compacts a
// row's valid lanes in lane order (ballot + popc) and takes them T = 64 at
// a time; a tile holds T pairs of each stream's current row (empty slots
// carry zeros), so each row's pairs are summed by its own threads and a
// tile needs no segmented sums. w1, b1, w2 and b2 sit in shared memory, in
// float32, for the block's life. Per tile: the Gaussians and the cutoff
// into a [G][2 T] tile; h = gauss w1 into registers; act = ssp(h + b1) or
// tanh(h + b1) into a [W][2 T] tile; y1 = act w2 into registers. Both
// products are register-tiled: a thread holds 8 pairs (runs of 4, 16
// apart) x W / 16 columns (runs of W / 32, W / 4 apart), and a k-step
// reads two 16-byte pieces of the pair tile and two of the weight row,
// which the warp's lanes share as broadcasts, for 8 W / 16 FFMAs; the next
// step's operands are loaded while a step's FFMAs run. A quarter warp
// spans 4 pair runs and 2 column runs, so its 16-byte stores to the act
// tile hit 32 distinct banks. The thread's x[j] columns come in from L2
// (x is a few MB) by 16-byte loads issued after the y1 product. The
// epilogue applies b2 and fc in registers and adds the tile's messages
// (y1 fc) * x[j] to the thread's column sums. When a stream's row is done,
// its sums are reduced across the warp by shuffles and across its two
// pair warps in shared memory, in a fixed order, and written once; then
// the stream compacts its next row. No atomics: two launches on the same
// inputs are bitwise equal. The special-function unit's exp and log2 in
// ssp (2 a filter value, 16 a clock an SM) take about 2,000 of a tile's
// ~39,000 clocks.
//
// Shared memory at W = 128 (floats): w2 [W][W] 64 KB, w1 [64][W] 32 KB,
// the act tile [W][2 T + 4] 66 KB, the Gaussian tile [64][2 T + 4] 33 KB,
// the row-end sums, biases, centers, the tile's pair data and the two
// streams' lane lists (8 K bytes): 205 KB at K = 640.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kT = 64;                 // pairs of a stream per tile
constexpr int kTT = 2 * kT;            // pairs per tile
constexpr int kGMax = 64;              // Gaussians, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.69314718055994531f;
constexpr int kSmemLimit = 232448;

struct Params {
  int n, k, g;
  float inv_gw, pi_rc;
};

// Shared-memory carve in floats; every array starts on 16 bytes. Pair
// arrays hold the tile's TT = 2 T pairs, stream s in slots s T .. s T + T.
template <int W>
struct Carve {
  static constexpr int AS = kTT + 4;   // pair-tile row stride
  static constexpr int w2 = 0, w1 = w2 + W * W, act = w1 + kGMax * W,
                       gau = act + W * AS, red = gau + kGMax * AS,
                       b1 = red + 4 * W, b2 = b1 + W, cen = b2 + W,
                       pd = cen + kGMax, pfc = pd + kTT, pj = pfc + kTT,
                       pl = pj + kTT, wc = pl + kTT, list = wc + 8;
  static constexpr int bytes(int k) { return 4 * (list + 2 * k); }
};

// exp(x) and log2(x) by the special-function unit (about 2 ulp; denormals
// flush to 0).
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// CV consecutive floats from global memory through the read-only path.
template <int CV>
__device__ __forceinline__ void ldg_cv(float (&v)[CV], const float* p) {
  if constexpr (CV == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (CV == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = __ldg(p);
  }
}

// CV consecutive floats from shared memory (16, 8 or 4 bytes).
template <int CV>
__device__ __forceinline__ void load_cv(float (&v)[CV], const float* p) {
  if constexpr (CV == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (CV == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

// acc[r][v] += sum_k a[k][pair r] b[k][col v] over k in [k0, k1), in k
// order, KU steps unrolled. a: a pair tile [k][AS]; b: a weight matrix
// [k][W]. Pairs: r < 4 at r0 + r, r >= 4 at r0 + 12 + r; columns: v < CV
// at ca + v, v >= CV (NR = 2 runs) at cb + v - CV. The operands of step
// k + 1 are loaded while step k's FFMAs run (the row after the last one
// read lies inside the shared allocation).
template <int W, int CV, int AS, int KU, int NR>
__device__ __forceinline__ void tile_gemm(float (&acc)[8][NR * CV],
                                          const float* __restrict__ a,
                                          const float* __restrict__ b, int k0,
                                          int k1, int r0, int ca, int cb) {
  float av[8], bv[NR][CV];
  auto load = [&](int k, float (&ar)[8], float (&br)[NR][CV]) {
    const float4 lo = *reinterpret_cast<const float4*>(a + k * AS + r0);
    const float4 hi = *reinterpret_cast<const float4*>(a + k * AS + r0 + 16);
    ar[0] = lo.x, ar[1] = lo.y, ar[2] = lo.z, ar[3] = lo.w;
    ar[4] = hi.x, ar[5] = hi.y, ar[6] = hi.z, ar[7] = hi.w;
    load_cv<CV>(br[0], b + k * W + ca);
    if constexpr (NR == 2) load_cv<CV>(br[1], b + k * W + cb);
  };
  auto step = [&](int k) {
    float an[8], bn[NR][CV];
    load(k + 1, an, bn);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int v = 0; v < CV; ++v)
          acc[r][n * CV + v] = fmaf(av[r], bv[n][v], acc[r][n * CV + v]);
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = an[r];
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int v = 0; v < CV; ++v) bv[n][v] = bn[n][v];
  };
  load(k0, av, bv);
  int k = k0;
#pragma unroll 1
  for (; k + KU <= k1; k += KU) {
#pragma unroll
    for (int kk = 0; kk < KU; ++kk) step(k + kk);
  }
#pragma unroll 1
  for (; k < k1; ++k) step(k);
}

template <int W, bool TANH>
__global__ void __launch_bounds__(kThreads, 1)
cfconv_fwd_kernel(const float* __restrict__ dist,
                  const uint8_t* __restrict__ mask,
                  const int* __restrict__ idx, const float* __restrict__ x,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ centers, float* __restrict__ out,
                  const Params p) {
  using C = Carve<W>;
  constexpr int AS = C::AS;
  constexpr int CV = W / 32;           // columns of one run a thread holds
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  float* w2s = sm + C::w2;
  float* w1s = sm + C::w1;
  float* act = sm + C::act;
  float* gau = sm + C::gau;
  float* red = sm + C::red;
  float* b1s = sm + C::b1;
  float* b2s = sm + C::b2;
  float* cen = sm + C::cen;
  float* pd = sm + C::pd;
  float* pfc = sm + C::pfc;
  int* pj = reinterpret_cast<int*>(sm + C::pj);
  int* pl = reinterpret_cast<int*>(sm + C::pl);
  int* wc = reinterpret_cast<int*>(sm + C::wc);
  int* lists = reinterpret_cast<int*>(sm + C::list);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.g, K = p.k, N = p.n;
  // This thread's pairs r0 .. r0 + 3 and r0 + 16 .. r0 + 19 of the tile,
  // all of stream ts, and its columns ca + v and cb + v (v < CV). A
  // quarter warp (8 lanes) spans 4 pair runs and 2 column runs, so its
  // 16-byte stores to the act tile hit 32 distinct banks.
  const int wp = warp & 3, ts = wp >> 1;
  const int r0 = 32 * wp + 4 * (lane & 3);
  const int ca = (warp >> 2) * (W / 2) + (lane >> 2) * CV, cb = ca + W / 4;

  for (int e = tid; e < W * W; e += kThreads) w2s[e] = w2[e];
  for (int e = tid; e < G * W; e += kThreads) w1s[e] = w1[e];
  for (int e = tid; e < W; e += kThreads) {
    b1s[e] = b1[e];
    b2s[e] = b2[e];
  }
  for (int e = tid; e < G; e += kThreads) cen[e] = centers[e];

  // Two row streams: stream s takes rows blockIdx.x + (2 m + s) gridDim.x.
  // row[s], count[s] (its valid lanes) and t[s] (the tile's first pair in
  // the row's lane list) are the same in every thread.
  const int step = 2 * gridDim.x;
  int row[2] = {(int)blockIdx.x, (int)(blockIdx.x + gridDim.x)};
  int count[2] = {0, 0}, t[2] = {0, 0};
  // Compacts row[s]'s valid lanes, in lane order, into the stream's list;
  // rows with none get zeros and are passed over.
  auto next_row = [&](int s) {
    int* list = lists + s * K;
    for (; row[s] < N; row[s] += step) {
      const size_t rowk = (size_t)row[s] * K;
      int c = 0;
      for (int base = 0; base < K; base += kThreads) {
        const int l = base + tid;
        const bool valid = l < K && mask[rowk + l];
        const unsigned bal = __ballot_sync(kFull, valid);
        if (lane == 0) wc[warp] = __popc(bal);
        __syncthreads();
        int off = c;
        for (int w = 0; w < warp; ++w) off += wc[w];
        if (valid) list[off + __popc(bal & ((1u << lane) - 1u))] = l;
        for (int w = 0; w < kThreads / 32; ++w) c += wc[w];
        __syncthreads();
      }
      count[s] = c;
      if (c > 0) break;
      for (int e = tid; e < W; e += kThreads)
        out[(size_t)row[s] * W + e] = 0.f;
    }
    t[s] = 0;
  };

  // Thread q < TT loads lane, neighbor and distance of slot q (stream q /
  // T) of the next tile a tile ahead, so their latency overlaps the tile
  // before. (Its stream's values are picked by value: a register array
  // takes only constant indices.)
  int nl = -1, nj = -1;
  float nd = 0.f;
  auto fetch = [&](int first) {
    const bool s1 = tid >= kT;
    const int rs = s1 ? row[1] : row[0], q = first + tid % kT;
    nl = -1;
    if (tid < kTT && rs < N && q < (s1 ? count[1] : count[0])) {
      const size_t rowk = (size_t)rs * K;
      nl = lists[(s1 ? K : 0) + q];
      nj = idx[rowk + nl];
      nd = dist[rowk + nl];
    }
  };

  float sum[2 * CV];
#pragma unroll
  for (int v = 0; v < 2 * CV; ++v) sum[v] = 0.f;
  __syncthreads();
  next_row(0);
  next_row(1);
  fetch(0);
  while (row[0] < N || row[1] < N) {
    // (a) The tile's pairs: lane, neighbor, distance.
    if (tid < kTT) {
      // The padding row (or no pair): a zero vector.
      pj[tid] = nl >= 0 && nj >= 0 && nj < N ? nj : -1;
      pl[tid] = nl;
      pd[tid] = nl >= 0 ? nd : 0.f;
      fetch((tid >= kT ? t[1] : t[0]) + kT);
    }
    __syncthreads();
    // (b) The Gaussians, [G][TT] (0 for empty slots), a thread taking slot
    // q and every other Gaussian, and the cutoff.
    {
      const int q = tid % kTT, g0 = tid / kTT;
      const float d = pd[q];
      const bool live = pl[q] >= 0;
#pragma unroll 4
      for (int g = g0; g < G; g += kThreads / kTT) {
        const float u = (d - cen[g]) * p.inv_gw;
        gau[g * AS + q] = live ? expf(-0.5f * u * u) : 0.f;
      }
      if (g0 == 0) pfc[q] = live ? 0.5f * cosf(p.pi_rc * d) + 0.5f : 0.f;
    }
    __syncthreads();

    // (c) h = gauss w1 -> act = ssp(h + b1) or tanh(h + b1), [W][TT].
    float acc[8][2 * CV];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int v = 0; v < 2 * CV; ++v) acc[r][v] = 0.f;
    tile_gemm<W, CV, AS, 8, 2>(acc, gau, w1s, 0, G, r0, ca, cb);
#pragma unroll
    for (int v = 0; v < 2 * CV; ++v) {
      const int c = v < CV ? ca + v : cb + v - CV;
      const float bias = b1s[c];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float h = acc[4 * half + r][v] + bias;
          if constexpr (TANH) {
            a[r] = tanhf(h);
          } else {
            // softplus(h) - log 2 = max(h, 0) + log(1 + exp(-|h|)) - log 2
            // (log2(1 + z) - 1 is exact for z in [0, 1]).
            const float z = fast_exp(-fabsf(h));
            a[r] = fmaxf(h, 0.f) + (fast_log2(1.f + z) - 1.f) * kLn2;
          }
        }
        *reinterpret_cast<float4*>(act + c * AS + r0 + 16 * half) =
            make_float4(a[0], a[1], a[2], a[3]);
      }
    }
    __syncthreads();

    // (d) y1 = act w2; the thread's x[j] columns, from L2, all loads issued
    // before the first use; the messages (y1 + b2) fc x[j] into the sums.
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int v = 0; v < 2 * CV; ++v) acc[r][v] = 0.f;
    tile_gemm<W, CV, AS, 8, 2>(acc, act, w2s, 0, W, r0, ca, cb);
    float xv[8][2 * CV];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = pj[r0 + (r < 4 ? r : 12 + r)];
      float xa[CV], xb[CV];
      if (j >= 0) {
        ldg_cv<CV>(xa, x + (size_t)j * W + ca);
        ldg_cv<CV>(xb, x + (size_t)j * W + cb);
      } else {
#pragma unroll
        for (int v = 0; v < CV; ++v) xa[v] = xb[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < CV; ++v) {
        xv[r][v] = xa[v];
        xv[r][CV + v] = xb[v];
      }
    }
    {
      float ba[CV], bb[CV], bv[2 * CV];
      load_cv<CV>(ba, b2s + ca);
      load_cv<CV>(bb, b2s + cb);
#pragma unroll
      for (int v = 0; v < CV; ++v) bv[v] = ba[v], bv[CV + v] = bb[v];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float fc = pfc[r0 + (r < 4 ? r : 12 + r)];
#pragma unroll
        for (int v = 0; v < 2 * CV; ++v)
          sum[v] = fmaf((acc[r][v] + bv[v]) * fc, xv[r][v], sum[v]);
      }
    }
    __syncthreads();                   // the tiles are free

    // A stream whose row is done: its sums over the 4 pair runs of a warp
    // (adjacent lanes), then over its 2 pair warps, in a fixed order, are
    // the row's output; then its next row.
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (row[s] >= N) continue;
      t[s] += kT;
      if (t[s] < count[s]) continue;
#pragma unroll
      for (int v = 0; v < 2 * CV; ++v) {
        float a = sum[v];
        a += __shfl_xor_sync(kFull, a, 1);
        a += __shfl_xor_sync(kFull, a, 2);
        if (ts == s) sum[v] = a;
      }
      if (ts == s && (lane & 3) == 0) {
        float* rs = red + (2 * s + (wp & 1)) * W;
#pragma unroll
        for (int v = 0; v < CV; ++v) {
          rs[ca + v] = sum[v];
          rs[cb + v] = sum[CV + v];
        }
      }
      __syncthreads();
      for (int e = tid; e < W; e += kThreads)
        out[(size_t)row[s] * W + e] =
            red[2 * s * W + e] + red[(2 * s + 1) * W + e];
      if (ts == s) {
#pragma unroll
        for (int v = 0; v < 2 * CV; ++v) sum[v] = 0.f;
      }
      row[s] += step;
      next_row(s);
      // Refetch this stream's slots of the next tile from its new row.
      if (tid / kT == s) fetch(0);
    }
  }
}

template <int W>
int launch(const float* dist, const uint8_t* mask, const int* idx,
           const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* centers, float* out, int nblocks,
           bool tanh_act, const Params& p, cudaStream_t stream) {
  const int smem = Carve<W>::bytes(p.k);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const auto kernel = tanh_act ? cfconv_fwd_kernel<W, true>
                               : cfconv_fwd_kernel<W, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblocks, kThreads, smem, stream>>>(dist, mask, idx, x, w1, b1, w2,
                                              b2, centers, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dist [n, k] f32, mask [n, k] u8, idx [n, k] i32 (n = padding), x [n,
// width] f32 (16-byte aligned), w1 [g, width], b1 [width], w2 [width,
// width], b2 [width], centers [g] f32. Output: out [n, width].
int cfconv_fwd(const float* dist, const uint8_t* mask, const int* idx,
               const float* x, const float* w1, const float* b1,
               const float* w2, const float* b2, const float* centers,
               float* out, int n, int k, int width, int g, int nblocks,
               int tanh_act, double inv_gw, double pi_rc, void* stream) {
  if (n < 1 || k < 1 || g < 1 || g > kGMax || nblocks < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.n = n;
  p.k = k;
  p.g = g;
  p.inv_gw = (float)inv_gw;
  p.pi_rc = (float)pi_rc;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 32:
      return launch<32>(dist, mask, idx, x, w1, b1, w2, b2, centers, out,
                        nblocks, tanh_act, p, s);
    case 64:
      return launch<64>(dist, mask, idx, x, w1, b1, w2, b2, centers, out,
                        nblocks, tanh_act, p, s);
    case 128:
      return launch<128>(dist, mask, idx, x, w1, b1, w2, b2, centers, out,
                         nblocks, tanh_act, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
