// CFConv backward over a directed per-atom neighbor list, for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_cfconv.py:47
// make_cfconv_bwd_kernel (kernel body :109, pl.pallas_call at :182).
// Wrapper, plain PyTorch version and autograd Function:
// nnpops_tpu_torch/ops/cuda_cfconv.py (its docstring states the contract).
//
// For atom row i and lane l with mask[i, l] (the JAX default XLA backward's
// validity; the Pallas kernel's dist > 0 differs for coincident atoms),
// j = idx[i, l], d = dist[i, l], the filter is recomputed,
//   gauss_g = exp(-((d - c_g) / gw)^2 / 2), h = gauss w1 + b1,
//   act = ssp(h) or tanh(h), y1 = act w2 + b2, fc = cos cutoff, y2 = y1 fc,
// and with the output cotangent g:
//   d_x[i]   += y2 * g[j]           (self-adjoint input-gradient rows)
//   d_y1      = g[i] * x[j] * fc,   d_fc = sum_w g[i] x[j] y1
//   d_h       = (d_y1 w2^T) * act'(h),  d_gauss = d_h w1^T
//   d_dist    = sum_g d_gauss gauss (-(d - c_g) / gw^2) + d_fc fc'(d)
//   dW2 += act^T d_y1, db2 += d_y1, dW1 += gauss^T d_h, db1 += d_h.
// Masked lanes get d_dist = 0 and are skipped, not computed.
//
// What bounds it on the H100: FP32 operations. Per valid pair the four
// products (h, y1, d_act, d_gauss) and the two weight-gradient outer
// products are 3 W^2 + 3 G W FMAs (68,352 at W = 128, G = 50), about 1.4e5
// operations, against about 1 KB of gathered rows (x[j], g[j]) a pair.
//
// Design: one block of 8 warps per SM walks atom rows (row i = blockIdx.x
// + k gridDim.x). The block stages w1 and w2 in shared memory (row stride
// W + 1, so both w2 and w2^T reads are free of bank conflicts; 91 KB at
// W = 128, G = 50), compacts the row's valid lanes (ballot + popc, fixed
// order), and takes them in tiles of 32 pairs. Per tile the four products
// run as SIMT tile products in f32: warp w owns pairs 4w..4w+3, lane c
// owns columns c + 32k; the tile's act, d_y1 and d_h go through shared
// memory. x[j] and g[j] are gathered straight from device memory, so the
// [R, K, W] tensors the JAX package materialises for the Pallas call are
// never built. Each thread keeps its share of dW1/dW2/db1/db2 in registers
// for the block's whole life; the block writes its partials once and a
// second kernel sums the partials of all blocks in block order. d_x rows
// are reduced across the warps in fixed order. No float atomics: every
// result is deterministic.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                      // pairs per tile
constexpr int kPairs = kTile / kWarps;         // pairs per warp (4)
constexpr int kMaxG = 64;                      // gaussians (padded)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.69314718055994531f;

struct Params {
  int n, k, g, tanh_act;
  float inv_gw, pi_rc;
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared-memory carve, in floats (every region starts 16-byte aligned).
template <int W>
struct Carve {
  static constexpr int WS = W + 1;         // w1/w2 row stride
  static constexpr int TS = W + 4;         // tile-matrix row stride
  static constexpr int GS = kMaxG + 4;     // gauss-tile row stride
  int w1, w2, b1, b2, cen, gc, act, dy1, dh, gauss, pd, pfc, pdfc, sdx,
      pj, pl, wc, list, total;
  __host__ __device__ explicit Carve(int g, int k) {
    int o = 0;
    w1 = o;    o = round4(o + g * WS);
    w2 = o;    o = round4(o + W * WS);
    b1 = o;    o = round4(o + W);
    b2 = o;    o = round4(o + W);
    cen = o;   o = round4(o + kMaxG);
    gc = o;    o = round4(o + W);
    act = o;   o = round4(o + kTile * TS);
    dy1 = o;   o = round4(o + kTile * TS);
    dh = o;    o = round4(o + kTile * TS);
    gauss = o; o = round4(o + kTile * GS);
    pd = o;    o = round4(o + kTile);
    pfc = o;   o = round4(o + kTile);
    pdfc = o;  o = round4(o + kTile);
    sdx = o;   o = round4(o + kWarps * W);
    pj = o;    o = round4(o + kTile);      // ints from here on
    pl = o;    o = round4(o + kTile);
    wc = o;    o = round4(o + kWarps);
    list = o;  o = round4(o + k);
    total = o;
  }
};

template <int W>
__host__ __device__ constexpr int partial_size(int g) {
  return g * W + W + W * W + W;
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
cfconv_bwd_kernel(const float* __restrict__ dist,
                  const uint8_t* __restrict__ mask,
                  const int* __restrict__ idx, const float* __restrict__ x,
                  const float* __restrict__ gout,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ centers,
                  float* __restrict__ d_dist, float* __restrict__ d_x,
                  float* __restrict__ part, const Params p) {
  constexpr int NC = W / 32;            // columns per lane
  constexpr int R = kThreads / W;       // row groups of the dW ownership
  constexpr int AR = W / R;             // dW2 rows per thread
  constexpr int GR = kMaxG / R;         // dW1 rows per thread (padded)
  using C = Carve<W>;
  constexpr int WS = C::WS, TS = C::TS, GS = C::GS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const C cv(p.g, p.k);
  float* w1s = sm + cv.w1;
  float* w2s = sm + cv.w2;
  float* b1s = sm + cv.b1;
  float* b2s = sm + cv.b2;
  float* cen = sm + cv.cen;
  float* gc = sm + cv.gc;
  float* tact = sm + cv.act;
  float* tdy1 = sm + cv.dy1;
  float* tdh = sm + cv.dh;
  float* tgauss = sm + cv.gauss;
  float* pd = sm + cv.pd;
  float* pfc = sm + cv.pfc;
  float* pdfc = sm + cv.pdfc;
  float* sdx = sm + cv.sdx;
  int* pj = reinterpret_cast<int*>(sm + cv.pj);
  int* pl = reinterpret_cast<int*>(sm + cv.pl);
  int* wc = reinterpret_cast<int*>(sm + cv.wc);
  int* list = reinterpret_cast<int*>(sm + cv.list);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.g, K = p.k, N = p.n;
  for (int e = tid; e < G * W; e += kThreads)
    w1s[(e / W) * WS + e % W] = w1[e];
  for (int e = tid; e < W * W; e += kThreads)
    w2s[(e / W) * WS + e % W] = w2[e];
  for (int e = tid; e < W; e += kThreads) {
    b1s[e] = b1[e];
    b2s[e] = b2[e];
  }
  for (int e = tid; e < kMaxG; e += kThreads) cen[e] = e < G ? centers[e] : 0.f;
  // Gauss columns >= G stay 0: they add nothing to dW1.
  for (int e = tid; e < kTile * GS; e += kThreads) tgauss[e] = 0.f;

  // Weight-gradient ownership: thread (rg, col) holds dW2[rg*AR + r][col]
  // and dW1[rg*GR + r][col], and db1/db2[col] (summed by every row group,
  // written by rg 0).
  const int col = tid % W, rg = tid / W;
  float acc2[AR], acc1[GR];
#pragma unroll
  for (int r = 0; r < AR; ++r) acc2[r] = 0.f;
#pragma unroll
  for (int r = 0; r < GR; ++r) acc1[r] = 0.f;
  float accb1 = 0.f, accb2 = 0.f;
  const int p0 = warp * kPairs;         // this warp's pairs in a tile
  __syncthreads();

  for (int i = blockIdx.x; i < N; i += gridDim.x) {
    const size_t rowk = (size_t)i * K;
    for (int e = tid; e < W; e += kThreads) gc[e] = gout[(size_t)i * W + e];
    // Compact the row's valid lanes, in lane order.
    int count = 0;
    for (int base = 0; base < K; base += kThreads) {
      const int l = base + tid;
      const bool valid = l < K && mask[rowk + l];
      if (l < K && !valid) d_dist[rowk + l] = 0.f;
      const unsigned bal = __ballot_sync(kFull, valid);
      if (lane == 0) wc[warp] = __popc(bal);
      __syncthreads();
      int off = count;
      for (int w = 0; w < warp; ++w) off += wc[w];
      if (valid) list[off + __popc(bal & ((1u << lane) - 1u))] = l;
      for (int w = 0; w < kWarps; ++w) count += wc[w];
      __syncthreads();
    }

    float dxa[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) dxa[c] = 0.f;

    for (int t0 = 0; t0 < count; t0 += kTile) {
      // (a) The tile's pairs: lane, neighbor, distance, cutoff terms.
      if (tid < kTile) {
        const int q = t0 + tid;
        int j = -1, l = 0;
        float d = 0.f, fc = 0.f, dfc = 0.f;
        if (q < count) {
          l = list[q];
          j = idx[rowk + l];
          if (j < 0 || j >= N) j = -1;    // the padding row: zero vectors
          d = dist[rowk + l];
          float s, c;
          sincosf(p.pi_rc * d, &s, &c);
          fc = 0.5f * c + 0.5f;
          dfc = -0.5f * p.pi_rc * s;
        }
        pj[tid] = j;
        pl[tid] = q < count ? l : -1;
        pd[tid] = d;
        pfc[tid] = fc;
        pdfc[tid] = dfc;
      }
      __syncthreads();
      // (b) Gaussians (0 for the tile's empty slots).
      for (int e = tid; e < kTile * G; e += kThreads) {
        const int q = e / G, gg = e - q * G;
        const float u = (pd[q] - cen[gg]) * p.inv_gw;
        tgauss[q * GS + gg] = pl[q] >= 0 ? expf(-0.5f * u * u) : 0.f;
      }
      __syncthreads();
      // (c) h = gauss w1 + b1 -> act, act' (registers), act -> smem.
      float sig[kPairs][NC], y1[kPairs][NC];
      {
        float h[kPairs][NC];
#pragma unroll
        for (int q = 0; q < kPairs; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c) h[q][c] = b1s[lane + 32 * c];
        for (int gg = 0; gg < G; ++gg) {
          float wv[NC], gv[kPairs];
#pragma unroll
          for (int c = 0; c < NC; ++c) wv[c] = w1s[gg * WS + lane + 32 * c];
#pragma unroll
          for (int q = 0; q < kPairs; ++q) gv[q] = tgauss[(p0 + q) * GS + gg];
#pragma unroll
          for (int q = 0; q < kPairs; ++q)
#pragma unroll
            for (int c = 0; c < NC; ++c) h[q][c] = fmaf(gv[q], wv[c], h[q][c]);
        }
#pragma unroll
        for (int q = 0; q < kPairs; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float hv = h[q][c];
            float a;
            if (p.tanh_act) {
              a = tanhf(hv);
              sig[q][c] = 1.f - a * a;
            } else {
              a = fmaxf(hv, 0.f) + log1pf(expf(-fabsf(hv))) - kLn2;
              sig[q][c] = 1.f / (1.f + expf(-hv));
            }
            tact[(p0 + q) * TS + lane + 32 * c] = a;
          }
      }
      __syncthreads();
      // (d) y1 = act w2 + b2.
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
#pragma unroll
        for (int c = 0; c < NC; ++c) y1[q][c] = b2s[lane + 32 * c];
      for (int a = 0; a < W; ++a) {
        float wv[NC], av[kPairs];
#pragma unroll
        for (int c = 0; c < NC; ++c) wv[c] = w2s[a * WS + lane + 32 * c];
#pragma unroll
        for (int q = 0; q < kPairs; ++q) av[q] = tact[(p0 + q) * TS + a];
#pragma unroll
        for (int q = 0; q < kPairs; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c) y1[q][c] = fmaf(av[q], wv[c], y1[q][c]);
      }
      // (e) Gather x[j], g[j]: d_y1 -> smem, d_fc (warp sums), d_x rows.
      float dfcs[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int j = pj[p0 + q];
        const float fc = pfc[p0 + q];
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int cc = lane + 32 * c;
          float xj = 0.f, gj = 0.f;
          if (j >= 0) {
            xj = x[(size_t)j * W + cc];
            gj = gout[(size_t)j * W + cc];
          }
          const float t = gc[cc] * xj;
          tdy1[(p0 + q) * TS + cc] = t * fc;
          s = fmaf(t, y1[q][c], s);
          dxa[c] = fmaf(y1[q][c] * fc, gj, dxa[c]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(kFull, s, off);
        dfcs[q] = s;
      }
      __syncthreads();
      // (f) d_h = (d_y1 w2^T) * act' -> smem.
      {
        float da[kPairs][NC];
#pragma unroll
        for (int q = 0; q < kPairs; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c) da[q][c] = 0.f;
        for (int b = 0; b < W; ++b) {
          float wv[NC], dv[kPairs];
#pragma unroll
          for (int c = 0; c < NC; ++c) wv[c] = w2s[(lane + 32 * c) * WS + b];
#pragma unroll
          for (int q = 0; q < kPairs; ++q) dv[q] = tdy1[(p0 + q) * TS + b];
#pragma unroll
          for (int q = 0; q < kPairs; ++q)
#pragma unroll
            for (int c = 0; c < NC; ++c) da[q][c] = fmaf(dv[q], wv[c], da[q][c]);
        }
#pragma unroll
        for (int q = 0; q < kPairs; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tdh[(p0 + q) * TS + lane + 32 * c] = da[q][c] * sig[q][c];
      }
      __syncthreads();
      // (g1) d_gauss = d_h w1^T and the distance cotangent: lane owns
      // gaussians lane and lane + 32.
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        float dg0 = 0.f, dg1 = 0.f;
        const int g0 = lane, g1 = lane + 32;
        const float* dhq = tdh + (p0 + q) * TS;
        if (g0 < G)
          for (int a = 0; a < W; ++a) dg0 = fmaf(dhq[a], w1s[g0 * WS + a], dg0);
        if (g1 < G)
          for (int a = 0; a < W; ++a) dg1 = fmaf(dhq[a], w1s[g1 * WS + a], dg1);
        const float d = pd[p0 + q];
        float s = 0.f;
        if (g0 < G) {
          const float u = (d - cen[g0]) * p.inv_gw;
          s += dg0 * tgauss[(p0 + q) * GS + g0] * (-u * p.inv_gw);
        }
        if (g1 < G) {
          const float u = (d - cen[g1]) * p.inv_gw;
          s += dg1 * tgauss[(p0 + q) * GS + g1] * (-u * p.inv_gw);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(kFull, s, off);
        const int l = pl[p0 + q];
        if (lane == 0 && l >= 0)
          d_dist[rowk + l] = s + dfcs[q] * pdfc[p0 + q];
      }
      // (g2) Weight gradients of the tile, into the thread's registers.
      for (int q = 0; q < kTile; ++q) {
        const float dh = tdh[q * TS + col];
        const float dy = tdy1[q * TS + col];
        const float4* ga = reinterpret_cast<const float4*>(
            tgauss + q * GS + rg * GR);
#pragma unroll
        for (int r = 0; r < GR / 4; ++r) {
          const float4 v = ga[r];
          acc1[4 * r] = fmaf(v.x, dh, acc1[4 * r]);
          acc1[4 * r + 1] = fmaf(v.y, dh, acc1[4 * r + 1]);
          acc1[4 * r + 2] = fmaf(v.z, dh, acc1[4 * r + 2]);
          acc1[4 * r + 3] = fmaf(v.w, dh, acc1[4 * r + 3]);
        }
        const float4* aa = reinterpret_cast<const float4*>(
            tact + q * TS + rg * AR);
#pragma unroll
        for (int r = 0; r < AR / 4; ++r) {
          const float4 v = aa[r];
          acc2[4 * r] = fmaf(v.x, dy, acc2[4 * r]);
          acc2[4 * r + 1] = fmaf(v.y, dy, acc2[4 * r + 1]);
          acc2[4 * r + 2] = fmaf(v.z, dy, acc2[4 * r + 2]);
          acc2[4 * r + 3] = fmaf(v.w, dy, acc2[4 * r + 3]);
        }
        accb1 += dh;
        accb2 += dy;
      }
      __syncthreads();
    }

    // The row's d_x: the warps' column partials, summed in warp order.
#pragma unroll
    for (int c = 0; c < NC; ++c) sdx[warp * W + lane + 32 * c] = dxa[c];
    __syncthreads();
    for (int e = tid; e < W; e += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += sdx[w * W + e];
      d_x[(size_t)i * W + e] = s;
    }
    __syncthreads();
  }

  // The block's partials: [dW1 G*W | db1 W | dW2 W*W | db2 W].
  float* out = part + (size_t)blockIdx.x * partial_size<W>(G);
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int gg = rg * GR + r;
    if (gg < G) out[gg * W + col] = acc1[r];
  }
#pragma unroll
  for (int r = 0; r < AR; ++r)
    out[G * W + W + (rg * AR + r) * W + col] = acc2[r];
  if (rg == 0) {
    out[G * W + col] = accb1;
    out[G * W + W + W * W + col] = accb2;
  }
}

// Sum of the blocks' partials, in block order.
__global__ void cfconv_bwd_reduce(const float* __restrict__ part,
                                  float* __restrict__ out, int nblocks,
                                  int size) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[(size_t)b * size + e];
  out[e] = s;
}

template <int W>
int launch(const float* dist, const uint8_t* mask, const int* idx,
           const float* x, const float* gout, const float* w1,
           const float* b1, const float* w2, const float* b2,
           const float* centers, float* d_dist, float* d_x, float* part,
           float* dw, int n, int k, int g, int nblocks, const Params& p,
           cudaStream_t stream) {
  const size_t smem = (size_t)Carve<W>(g, k).total * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cfconv_bwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cfconv_bwd_kernel<W><<<nblocks, kThreads, smem, stream>>>(
      dist, mask, idx, x, gout, w1, b1, w2, b2, centers, d_dist, d_x, part,
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = partial_size<W>(g);
  cfconv_bwd_reduce<<<(size + 255) / 256, 256, 0, stream>>>(part, dw,
                                                           nblocks, size);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dist [n, k] f32, mask [n, k] u8, idx [n, k] i32 (n = padding), x and
// gout [n, width] f32, w1 [g, width], b1 [width], w2 [width, width],
// b2 [width], centers [g] f32. Outputs: d_dist [n, k], d_x [n, width],
// dw [g*width + width + width*width + width] (dW1 | db1 | dW2 | db2), with
// scratch part [nblocks, that size].
int cfconv_bwd(const float* dist, const uint8_t* mask, const int* idx,
               const float* x, const float* gout, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* centers, float* d_dist, float* d_x, float* part,
               float* dw, int n, int k, int width, int g, int nblocks,
               int tanh_act, double inv_gw, double pi_rc, void* stream) {
  if (n < 1 || k < 1 || g < 1 || g > kMaxG || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.n = n;
  p.k = k;
  p.g = g;
  p.tanh_act = tanh_act;
  p.inv_gw = (float)inv_gw;
  p.pi_rc = (float)pi_rc;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 32:
      return launch<32>(dist, mask, idx, x, gout, w1, b1, w2, b2, centers,
                        d_dist, d_x, part, dw, n, k, g, nblocks, p, s);
    case 64:
      return launch<64>(dist, mask, idx, x, gout, w1, b1, w2, b2, centers,
                        d_dist, d_x, part, dw, n, k, g, nblocks, p, s);
    case 128:
      return launch<128>(dist, mask, idx, x, gout, w1, b1, w2, b2, centers,
                         d_dist, d_x, part, dw, n, k, g, nblocks, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
