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
// What bounds it on the H100: the tensor cores. Per valid pair the four
// filter products (h, y1, d_act, d_gauss) and the two weight-gradient
// products are 3 W^2 + 3 G W multiply-adds (68,352 at W = 128, G = 50),
// run as three bf16 passes (below) against about 1 KB of gathered rows.
//
// Design. One persistent block of two warpgroups per SM walks atom rows
// (row i = blockIdx.x + k gridDim.x), compacts the row's valid lanes in lane
// order (ballot + popc) and takes them in tiles of T = 64 pairs; empty
// slots of the last tile carry zeros. Every product is a wgmma with
// M = 64 (the tile's pairs, or 64 weight rows for dW), f32 accumulators,
// each warpgroup owning one half of the output columns:
//   h = gauss w1 (K = 64, G padded with zeros), y1 = act w2, d_act =
//   d_y1 w2^T, d_gauss = d_h w1^T (N = 32 a warpgroup), dW2 += act^T d_y1
//   and dW1 += gauss^T d_h (K = the tile's 64 pairs).
// Three-pass split: every operand a is held as hi = bf16(a) and lo =
// bf16(a - hi), and each product is hi.hi + hi.lo + lo.hi, which keeps the
// f32 gates (about 2^-16 relative; one bf16 pass misses the 1e-4 d_dist
// gate). Each matrix is stored once, row-major in the 128-byte swizzle
// layout (64-column panels of 128-byte rows), and read either K-major or,
// through wgmma's transpose bits, MN-major: w1 is K-major for d_gauss and
// MN-major for h, w2 likewise for d_act and y1, and the pair tiles act,
// gauss, d_y1, d_h are K-major A operands of the filter products and
// MN-major operands of the weight-gradient products. Widths under 64 are
// padded to 64 with zero weights and zero gathered columns.
// The elementwise epilogues run in f32 registers on the accumulators, with
// the special-function unit's exp, log and reciprocal (.approx.ftz): the
// activation and its derivative share one exp(-|h|); act' stays in
// registers from the h epilogue to the d_h epilogue. They, not the tensor
// cores, set the kernel's time: each stage waits for its products, so
// only dW2 and dW1 run on behind the d_h and d_dist epilogues. Each
// tile's lanes, neighbors and distances are loaded a tile ahead. x[j] and
// g[j] come in by 16-byte cp.async copies issued when the tile starts,
// into a stage that lands while the h and y1 products run (one tile ahead
// does not fit in shared memory); the y1 epilogue reads them, and d_y1
// and d_h then reuse the stage. dW1 and dW2 stay in the warpgroups'
// registers for the block's life; db1, db2 and the d_x rows are column
// sums reduced across
// the warp with a fixed shuffle reduce-scatter, then across warps in
// shared memory in warp order. Each block writes its partials once and a
// second kernel sums the blocks' partials in block order. No float
// atomics: two launches on the same inputs are bitwise equal.
//
// Shared memory at W = 128 (WP = padded width, bytes): w1 hi+lo 32 KB, w2
// hi+lo 64 KB, gauss hi+lo 16 KB, act hi+lo 32 KB, stage 68 KB (x[j] and
// g[j] f32, rows of WP + 8 floats against bank conflicts; d_y1 hi+lo
// reuses the x half after the y1 epilogue, d_h hi+lo the g half), then
// biases, g[i], centers, the tile's pair data and the row's lane list
// (4 K bytes): 219 KB at K = 640. The row-end d_x and block-end db sums
// reuse the act tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // two warpgroups
constexpr int kT = 64;                 // pairs per tile
constexpr int kGP = 64;                // Gaussians, padded
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.69314718055994531f;
constexpr int kSmemLimit = 232448;

struct Params {
  int n, k, g;
  float inv_gw, pi_rc;
};

__host__ __device__ constexpr int padded(int w) { return w < 64 ? 64 : w; }

// Shared-memory carve in bytes; the swizzled tiles start on 1024-byte
// boundaries (the swizzle repeats every 1024 bytes).
template <int W>
struct Carve {
  static constexpr int WP = padded(W);
  static constexpr int XS = WP + 8;              // stage row stride (floats)
  static constexpr int kW1 = kGP * WP * 2;       // one bf16 copy of w1
  static constexpr int kW2 = WP * WP * 2;
  static constexpr int kGa = kT * kGP * 2;
  static constexpr int kTile = kT * WP * 2;      // one bf16 copy of a pair tile
  static constexpr int kHalf = kT * XS * 4;      // one f32 stage half
  static constexpr int w1h = 0, w1l = w1h + kW1, w2h = w1l + kW1,
                       w2l = w2h + kW2, gah = w2l + kW2, gal = gah + kGa,
                       ach = gal + kGa, acl = ach + kTile, xs = acl + kTile,
                       gs = xs + kHalf, fl = gs + kHalf;
  // Floats from fl on: b1, b2, gc [WP]; cen, pd, pfc, pdfc [64]; sdfc,
  // sdd [2][64]; then ints pj, pl [64], wc [8], list [k].
  static constexpr int b1 = fl, b2 = b1 + 4 * WP, gc = b2 + 4 * WP,
                       cen = gc + 4 * WP, pd = cen + 256, pfc = pd + 256,
                       pdfc = pfc + 256, sdfc = pdfc + 256, sdd = sdfc + 512,
                       pj = sdd + 512, pl = pj + 256, wc = pl + 256,
                       list = wc + 32;
  static_assert(kHalf % 1024 == 0 && 2 * kTile <= kHalf, "stage reuse");
  static constexpr int bytes(int k) { return list + 4 * k + 1024; }
};

template <int W>
__host__ __device__ constexpr int partial_size(int g) {
  return g * W + W + W * W + W;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The warpgroup of this thread, as a warp-uniform value (a divergent one
// makes ptxas serialize the wgmmas).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(kFull, (int)(threadIdx.x >> 7), 0);
}

// Byte offset of element (r, c) of an R-row bf16 matrix in the 128-byte
// swizzle layout: 64-column panels of R rows of 128 bytes, the 16-byte
// pieces of row r permuted by r mod 8.
__device__ __forceinline__ int sw_off(int r, int c, int R) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         ((c & 7) << 1);
}

// wgmma operand descriptor (128-byte swizzle): lbo, sbo in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of the first 16-deep k-slice of an operand stored row-major
// in a tile of R rows (panel stride R * 128 bytes), from MN index mn on.
// TRANS 0, K-major: rows are the M or N index, columns K; 8-row groups
// 1024 bytes apart. TRANS 1, MN-major: rows are K, columns M or N; 8-row
// K groups 1024 bytes apart, 64-wide MN blocks one panel apart.
template <int TRANS>
__device__ __forceinline__ uint64_t op_desc(uint32_t base, int R, int mn) {
  if constexpr (TRANS == 0) return make_desc(base + mn * 128, 16, 1024);
  return make_desc(base + (mn >> 6) * (R * 128) + (mn & 63) * 2, R * 128,
                   1024);
}

// Offset of the k-slice at k0 from the first, in 16-byte units (the
// descriptor's address field).
template <int TRANS>
__device__ __forceinline__ uint32_t k_step(int R, int k0) {
  return (TRANS == 0 ? (k0 >> 6) * (R * 128) + (k0 & 63) * 2 : k0 * 128) >> 4;
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// acc += A B over KSTEPS k-slices of 16, in three bf16 passes (hi.hi,
// hi.lo, lo.hi). Each operand: hi and lo copies (shared addresses), its
// tile's row count and its M or N offset.
template <int TA, int TB, int N, int KSTEPS>
__device__ __forceinline__ void gemm3(float* acc, uint32_t ah, uint32_t al,
                                      int ar, int am, uint32_t bh,
                                      uint32_t bl, int br, int bn) {
  // Each later k-slice adds a constant to the first one's descriptors.
  const uint64_t dah0 = op_desc<TA>(ah, ar, am);
  const uint64_t dal0 = op_desc<TA>(al, ar, am);
  const uint64_t dbh0 = op_desc<TB>(bh, br, bn);
  const uint64_t dbl0 = op_desc<TB>(bl, br, bn);
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const uint32_t oa = k_step<TA>(ar, 16 * ks), ob = k_step<TB>(br, 16 * ks);
    const uint64_t dah = dah0 + oa, dal = dal0 + oa;
    const uint64_t dbh = dbh0 + ob, dbl = dbl0 + ob;
    if constexpr (N == 64) {
      wgmma_n64<TA, TB>(acc, dah, dbh);
      wgmma_n64<TA, TB>(acc, dah, dbl);
      wgmma_n64<TA, TB>(acc, dal, dbh);
    } else {
      wgmma_n32<TA, TB>(acc, dah, dbh);
      wgmma_n32<TA, TB>(acc, dah, dbl);
      wgmma_n32<TA, TB>(acc, dal, dbh);
    }
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory stores visible to the tensor cores'
// reads (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16-byte copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// exp(x), log(x) and 1 / x by the special-function unit (about 2 ulp;
// denormals flush to 0).
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
__device__ __forceinline__ float fast_log(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y * kLn2;
}
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stores (a, b) at columns c, c + 1 (c even) of a pair tile as hi and lo
// bf16 copies.
__device__ __forceinline__ void store_split(unsigned char* hi,
                                            unsigned char* lo, int off,
                                            float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) = l;
}

__device__ __forceinline__ void store_split1(unsigned char* hi,
                                             unsigned char* lo, int off,
                                             float a) {
  const bf16 h = __float2bfloat16_rn(a);
  *reinterpret_cast<bf16*>(hi + off) = h;
  *reinterpret_cast<bf16*>(lo + off) =
      __float2bfloat16_rn(a - __bfloat162float(h));
}

// Column sums of a warp's 16 accumulator rows. v[q] holds the thread's sum
// of column q (q = 2 j + e, column 8 j + 2 t + e of the fragment) over its
// two rows; after the reduce-scatter over the lanes' row bits (xor 16, 8,
// 4), v[0 .. NV/8) hold the warp's sums of columns col_of(q) for q =
// gq NV/8 + i. A fixed order: deterministic.
template <int NV>
__device__ __forceinline__ void reduce_scatter(float (&v)[NV], int lane) {
#pragma unroll
  for (int s = 16, half = NV / 2; s >= 4; s >>= 1, half >>= 1) {
    const bool up = lane & s;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      if (i < half) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, s);
      }
    }
  }
}

// Fragment column of q = 2 j + e for the thread with quad index t.
__device__ __forceinline__ int col_of(int q, int t) {
  return 8 * (q >> 1) + 2 * t + (q & 1);
}

template <int W, bool TANH>
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
  using C = Carve<W>;
  constexpr int WP = C::WP, XS = C::XS;
  constexpr int NH = WP / 2;           // output columns a warpgroup owns
  constexpr int NA = NH / 2;           // accumulator floats of m64nNH
  constexpr int NV = NH / 4;           // fragment columns a thread holds
  constexpr int NS = NV / 8;           // columns a lane keeps after reduce
  constexpr int MB = WP / 64;          // dW2 row blocks
  constexpr int KW = WP / 16;          // k-slices over the width
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* b1s = reinterpret_cast<float*>(sm + C::b1);
  float* b2s = reinterpret_cast<float*>(sm + C::b2);
  float* gc = reinterpret_cast<float*>(sm + C::gc);
  float* cen = reinterpret_cast<float*>(sm + C::cen);
  float* pd = reinterpret_cast<float*>(sm + C::pd);
  float* pfc = reinterpret_cast<float*>(sm + C::pfc);
  float* pdfc = reinterpret_cast<float*>(sm + C::pdfc);
  float* sdfc = reinterpret_cast<float*>(sm + C::sdfc);
  float* sdd = reinterpret_cast<float*>(sm + C::sdd);
  float* xs = reinterpret_cast<float*>(sm + C::xs);
  float* gs = reinterpret_cast<float*>(sm + C::gs);
  float* red = reinterpret_cast<float*>(sm + C::ach);   // row/block-end sums
  int* pj = reinterpret_cast<int*>(sm + C::pj);
  int* pl = reinterpret_cast<int*>(sm + C::pl);
  int* wc = reinterpret_cast<int*>(sm + C::wc);
  int* list = reinterpret_cast<int*>(sm + C::list);
  unsigned char* dyh = sm + C::xs;                 // d_y1 over the x stage
  unsigned char* dyl = dyh + C::kTile;
  unsigned char* dhh = sm + C::gs;                 // d_h over the g stage
  unsigned char* dhl = dhh + C::kTile;
  const uint32_t s0 = smem_u32(sm);
  const uint32_t u_w1h = s0 + C::w1h, u_w1l = s0 + C::w1l;
  const uint32_t u_w2h = s0 + C::w2h, u_w2l = s0 + C::w2l;
  const uint32_t u_gah = s0 + C::gah, u_gal = s0 + C::gal;
  const uint32_t u_ach = s0 + C::ach, u_acl = s0 + C::acl;
  const uint32_t u_dyh = smem_u32(dyh), u_dyl = smem_u32(dyl);
  const uint32_t u_dhh = smem_u32(dhh), u_dhl = smem_u32(dhl);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warpgroup(), wq = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int G = p.g, K = p.k, N = p.n;
  const int c0 = wg * NH;              // this warpgroup's first column

  // The weights, split once: w1 [kGP rows][WP], w2 [WP][WP], zero-padded.
  for (int e = tid; e < kGP * WP; e += kThreads) {
    const int r = e / WP, c = e % WP;
    store_split1(sm + C::w1h, sm + C::w1l, sw_off(r, c, kGP),
                 r < G && c < W ? w1[r * W + c] : 0.f);
  }
  for (int e = tid; e < WP * WP; e += kThreads) {
    const int r = e / WP, c = e % WP;
    store_split1(sm + C::w2h, sm + C::w2l, sw_off(r, c, WP),
                 r < W && c < W ? w2[r * W + c] : 0.f);
  }
  for (int e = tid; e < WP; e += kThreads) {
    b1s[e] = e < W ? b1[e] : 0.f;
    b2s[e] = e < W ? b2[e] : 0.f;
  }
  for (int e = tid; e < kGP; e += kThreads) cen[e] = e < G ? centers[e] : 0.f;

  float dw2[MB][NA], dw1[NA];
  float db1s[NS], db2s[NS];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int v = 0; v < NA; ++v) dw2[m][v] = 0.f;
#pragma unroll
  for (int v = 0; v < NA; ++v) dw1[v] = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s) db1s[s] = db2s[s] = 0.f;
  fence_async_smem();
  __syncthreads();

  for (int i = blockIdx.x; i < N; i += gridDim.x) {
    const size_t rowk = (size_t)i * K;
    for (int e = tid; e < WP; e += kThreads)
      gc[e] = e < W ? gout[(size_t)i * W + e] : 0.f;
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
      for (int w = 0; w < kThreads / 32; ++w) count += wc[w];
      __syncthreads();
    }

    float dxs[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) dxs[s] = 0.f;

    // Thread q < T loads lane, neighbor and distance of pair q of the next
    // tile a tile ahead, so their latency overlaps the tile before.
    int nl = -1, nj = -1;
    float nd = 0.f;
    auto fetch = [&](int q) {
      nl = -1;
      if (tid < kT && q < count) {
        nl = list[q];
        nj = idx[rowk + nl];
        nd = dist[rowk + nl];
      }
    };
    fetch(tid);
    for (int t0 = 0; t0 < count; t0 += kT) {
      // (a) The tile's pairs: lane, neighbor, distance, cutoff terms.
      if (tid < kT) {
        int j = -1;
        float d = 0.f, fc = 0.f, dfc = 0.f;
        if (nl >= 0) {
          j = nj < 0 || nj >= N ? -1 : nj;  // the padding row: zero vectors
          d = nd;
          float s, c;
          __sincosf(p.pi_rc * d, &s, &c);
          fc = 0.5f * c + 0.5f;
          dfc = -0.5f * p.pi_rc * s;
        }
        pj[tid] = j;
        pl[tid] = nl;
        pd[tid] = d;
        pfc[tid] = fc;
        pdfc[tid] = dfc;
        fetch(t0 + kT + tid);
      }
      __syncthreads();
      // Gather x[j] and g[j] into the stage (zeros for empty slots and
      // padded columns); they land while the h and y1 products run.
      // A thread copies one 16-byte column piece of every QS-th pair.
      {
        constexpr int CH = WP / 4, QS = kThreads / CH;
        const int c = 4 * (tid % CH), qa = tid / CH;
#pragma unroll
        for (int k = 0; k < kT / QS; ++k) {
          const int q = qa + QS * k, j = pj[q];
          const bool ok = c < W && j >= 0;
          const size_t off = ok ? (size_t)j * W + c : 0;
          cp_async16(xs + q * XS + c, x + off, ok);
          cp_async16(gs + q * XS + c, gout + off, ok);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      // (b) Gaussians, split (0 for empty slots and padded columns): a
      // thread takes one Gaussian column of every fourth pair.
      {
        const int gg = tid % kGP, qa = tid / kGP;
        const float cg = cen[gg];
#pragma unroll 4
        for (int k = 0; k < kT / (kThreads / kGP); ++k) {
          const int q = qa + (kThreads / kGP) * k;
          const float u = (pd[q] - cg) * p.inv_gw;
          const float v = gg < G && pl[q] >= 0 ? fast_exp(-0.5f * u * u) : 0.f;
          store_split1(sm + C::gah, sm + C::gal, sw_off(q, gg, kT), v);
        }
      }
      fence_async_smem();
      __syncthreads();

      // (c) h = gauss w1 + b1 -> act (hi/lo tile), act' (registers).
      float acc[NA], actd[NA];
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[v] = 0.f;
      wgmma_fence();
      gemm3<0, 1, NH, kGP / 16>(acc, u_gah, u_gal, kT, 0, u_w1h, u_w1l, kGP,
                                c0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq;
          const float2 bias = *reinterpret_cast<const float2*>(b1s + c);
          float a2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = 4 * jj + 2 * h + e;
            const float hv = acc[v] + (e ? bias.y : bias.x);
            if constexpr (TANH) {
              a2[e] = tanhf(hv);
              actd[v] = 1.f - a2[e] * a2[e];
            } else {
              const float z = fast_exp(-fabsf(hv));    // shared exp(-|h|)
              a2[e] = fmaxf(hv, 0.f) + fast_log(1.f + z) - kLn2;
              actd[v] = (hv >= 0.f ? 1.f : z) * fast_rcp(1.f + z);
            }
          }
          store_split(sm + C::ach, sm + C::acl, sw_off(r, c, kT), a2[0],
                      a2[1]);
        }
      fence_async_smem();
      __syncthreads();

      // (d) y1 = act w2 + b2; with the gathered rows: d_y1, d_fc, d_x.
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[v] = 0.f;
      wgmma_fence();
      gemm3<0, 1, NH, KW>(acc, u_ach, u_acl, kT, 0, u_w2h, u_w2l, WP, c0);
      wgmma_commit();
      wgmma_wait<0>();
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      {
        float cs[NV], dfc2[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NV; ++q) cs[q] = 0.f;
#pragma unroll
        for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq;
            const float fc = pfc[r];
            const float2 xv = *reinterpret_cast<const float2*>(xs + r * XS + c);
            const float2 gv = *reinterpret_cast<const float2*>(gs + r * XS + c);
            const float2 bias = *reinterpret_cast<const float2*>(b2s + c);
            const float2 gi = *reinterpret_cast<const float2*>(gc + c);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int v = 4 * jj + 2 * h + e;
              const float y = acc[v] + (e ? bias.y : bias.x);
              const float t = (e ? gi.y : gi.x) * (e ? xv.y : xv.x);
              dfc2[h] = fmaf(t, y, dfc2[h]);
              cs[2 * jj + e] = fmaf(y * fc, e ? gv.y : gv.x, cs[2 * jj + e]);
              acc[v] = t * fc;                          // d_y1
            }
          }
        reduce_scatter<NV>(cs, lane);
#pragma unroll
        for (int s = 0; s < NS; ++s) dxs[s] += cs[s];
#pragma unroll
        for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            cs[2 * jj + e] = acc[4 * jj + e] + acc[4 * jj + 2 + e];
        reduce_scatter<NV>(cs, lane);
#pragma unroll
        for (int s = 0; s < NS; ++s) db2s[s] += cs[s];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = dfc2[h];
          s += __shfl_xor_sync(kFull, s, 1);
          s += __shfl_xor_sync(kFull, s, 2);
          if (tq == 0) sdfc[wg * kT + 16 * wq + gq + 8 * h] = s;
        }
      }
      __syncthreads();                 // the x stage is read: d_y1 over it
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq;
          store_split(dyh, dyl, sw_off(r, c, kT), acc[4 * jj + 2 * h],
                      acc[4 * jj + 2 * h + 1]);
        }
      fence_async_smem();
      __syncthreads();

      // (e) d_act = d_y1 w2^T -> d_h = d_act act'; dW2 += act^T d_y1.
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[v] = 0.f;
      wgmma_fence();
      gemm3<0, 0, NH, KW>(acc, u_dyh, u_dyl, kT, 0, u_w2h, u_w2l, WP, c0);
      wgmma_commit();
#pragma unroll
      for (int m = 0; m < MB; ++m)
        gemm3<1, 1, NH, kT / 16>(dw2[m], u_ach, u_acl, kT, 64 * m, u_dyh,
                                 u_dyl, kT, c0);
      wgmma_commit();
      wgmma_wait<1>();                 // d_act; dW2 runs on meanwhile
      {
        float cs[NV];
#pragma unroll
        for (int v = 0; v < NA; ++v) acc[v] *= actd[v];          // d_h
#pragma unroll
        for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            cs[2 * jj + e] = acc[4 * jj + e] + acc[4 * jj + 2 + e];
        reduce_scatter<NV>(cs, lane);
#pragma unroll
        for (int s = 0; s < NS; ++s) db1s[s] += cs[s];
      }
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq;
          store_split(dhh, dhl, sw_off(r, c, kT), acc[4 * jj + 2 * h],
                      acc[4 * jj + 2 * h + 1]);
        }
      fence_async_smem();
      __syncthreads();

      // (f) d_gauss = d_h w1^T -> d_dist; dW1 += gauss^T d_h.
      {
        float ag[16];
#pragma unroll
        for (int v = 0; v < 16; ++v) ag[v] = 0.f;
        wgmma_fence();
        gemm3<0, 0, 32, KW>(ag, u_dhh, u_dhl, kT, 0, u_w1h, u_w1l, kGP,
                            32 * wg);
        wgmma_commit();
        gemm3<1, 1, NH, kT / 16>(dw1, u_gah, u_gal, kT, 0, u_dhh, u_dhl, kT,
                                 c0);
        wgmma_commit();
        wgmma_wait<1>();               // dW2, d_gauss; dW1 runs on meanwhile
        float s2[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wq + gq + 8 * h;
            // Columns gg >= G hold exact zeros (w1's padded rows are 0).
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int gg = 32 * wg + 8 * jj + 2 * tq + e;
              const float u = (pd[r] - cen[gg]) * p.inv_gw;
              s2[h] = fmaf(ag[4 * jj + 2 * h + e] * fast_exp(-0.5f * u * u),
                           -u * p.inv_gw, s2[h]);
            }
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = s2[h];
          s += __shfl_xor_sync(kFull, s, 1);
          s += __shfl_xor_sync(kFull, s, 2);
          if (tq == 0) sdd[wg * kT + 16 * wq + gq + 8 * h] = s;
        }
      }
      wgmma_wait<0>();                 // dW1: the tiles are free again
      __syncthreads();
      if (tid < kT && pl[tid] >= 0)
        d_dist[rowk + pl[tid]] = (sdd[tid] + sdd[kT + tid]) +
                                 (sdfc[tid] + sdfc[kT + tid]) * pdfc[tid];
    }

    // The row's d_x: the warps' column sums, added in warp order.
#pragma unroll
    for (int s = 0; s < NS; ++s)
      red[warp * WP + c0 + col_of(gq * NS + s, tq)] = dxs[s];
    __syncthreads();
    for (int e = tid; e < W; e += kThreads) {
      const int w0 = 4 * (e / NH);
      float s = 0.f;
      for (int w = 0; w < 4; ++w) s += red[(w0 + w) * WP + e];
      d_x[(size_t)i * W + e] = s;
    }
    __syncthreads();
  }

  // The block's partials: [dW1 G*W | db1 W | dW2 W*W | db2 W].
  float* out = part + (size_t)blockIdx.x * partial_size<W>(G);
#pragma unroll
  for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq + e;
        const int v = 4 * jj + 2 * h + e;
        if (c < W) {
          if (r < G) out[r * W + c] = dw1[v];
#pragma unroll
          for (int m = 0; m < MB; ++m)
            if (64 * m + r < W)
              out[G * W + W + (64 * m + r) * W + c] = dw2[m][v];
        }
      }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int c = c0 + col_of(gq * NS + s, tq);
    red[warp * WP + c] = db1s[s];
    red[(8 + warp) * WP + c] = db2s[s];
  }
  __syncthreads();
  for (int e = tid; e < W; e += kThreads) {
    const int w0 = 4 * (e / NH);
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < 4; ++w) {
      s1 += red[(w0 + w) * WP + e];
      s2 += red[(8 + w0 + w) * WP + e];
    }
    out[G * W + e] = s1;
    out[G * W + W + W * W + e] = s2;
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
           float* dw, int n, int k, int g, int nblocks, bool tanh_act,
           const Params& p, cudaStream_t stream) {
  const int smem = Carve<W>::bytes(k);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const auto kernel = tanh_act ? cfconv_bwd_kernel<W, true>
                               : cfconv_bwd_kernel<W, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblocks, kThreads, smem, stream>>>(
      dist, mask, idx, x, gout, w1, b1, w2, b2, centers, d_dist, d_x, part,
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = partial_size<W>(g);
  cfconv_bwd_reduce<<<(size + 255) / 256, 256, 0, stream>>>(part, dw,
                                                           nblocks, size);
  return (int)cudaGetLastError();
}

// The forces-only kernel: the same contract without the weight gradients,
// for when no filter weight needs one (MD, where only the positions do;
// ops/cuda_cfconv.py PayloadConv picks it from ctx.needs_input_grad). On
// that path it replaces cfconv_bwd_kernel and cfconv_bwd_reduce: dW1,
// dW2, db1 and db2 cost two of the six products (36 of a tile's 108
// m64n64k16 units a warpgroup, queued in issue order ahead of d_gauss and
// the next tile's h), their column sums, the block partials and a second
// launch, and autograd throws them away.
//
// What bounds it: the tensor cores, on the four filter products (2 W^2 +
// 2 G W multiply-adds a valid pair, three bf16 passes each), and the f32
// epilogues between them, which wait for their products.
//
// Design: cfconv_bwd_kernel's tile loop, layout and arithmetic with the
// weight-gradient products, sums and partials taken out, so d_dist and
// d_x are bitwise the full kernel's. The tile's chain in two rounds (h
// with d_act, then y1 with d_gauss: d_y1 = g[i] x[j] fc needs nothing of
// the filter) was built and measured slower on the H100 (12.14 against
// 11.42 ms on a 26k layer): it saves only two waits a tile, and it needs
// g[j] until the last epilogue while the stage holds the next tile's x[j],
// so g[j] came from L2 into registers, which alone cost 0.67 ms; issuing
// each round's second product behind the first one's epilogue gained
// nothing.
template <int W, bool TANH>
__global__ void __launch_bounds__(kThreads, 1)
cfconv_bwd_forces_kernel(const float* __restrict__ dist,
                         const uint8_t* __restrict__ mask,
                         const int* __restrict__ idx,
                         const float* __restrict__ x,
                         const float* __restrict__ gout,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ centers,
                         float* __restrict__ d_dist, float* __restrict__ d_x,
                         const Params p) {
  using C = Carve<W>;
  constexpr int WP = C::WP, XS = C::XS;
  constexpr int NH = WP / 2;           // output columns a warpgroup owns
  constexpr int NA = NH / 2;           // accumulator floats of m64nNH
  constexpr int NV = NH / 4;           // fragment columns a thread holds
  constexpr int NS = NV / 8;           // columns a lane keeps after reduce
  constexpr int KW = WP / 16;          // k-slices over the width
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* b1s = reinterpret_cast<float*>(sm + C::b1);
  float* b2s = reinterpret_cast<float*>(sm + C::b2);
  float* gc = reinterpret_cast<float*>(sm + C::gc);
  float* cen = reinterpret_cast<float*>(sm + C::cen);
  float* pd = reinterpret_cast<float*>(sm + C::pd);
  float* pfc = reinterpret_cast<float*>(sm + C::pfc);
  float* pdfc = reinterpret_cast<float*>(sm + C::pdfc);
  float* sdfc = reinterpret_cast<float*>(sm + C::sdfc);
  float* sdd = reinterpret_cast<float*>(sm + C::sdd);
  float* xs = reinterpret_cast<float*>(sm + C::xs);
  float* gs = reinterpret_cast<float*>(sm + C::gs);
  float* red = reinterpret_cast<float*>(sm + C::ach);   // row-end sums
  int* pj = reinterpret_cast<int*>(sm + C::pj);
  int* pl = reinterpret_cast<int*>(sm + C::pl);
  int* wc = reinterpret_cast<int*>(sm + C::wc);
  int* list = reinterpret_cast<int*>(sm + C::list);
  unsigned char* dyh = sm + C::xs;                 // d_y1 over the x stage
  unsigned char* dyl = dyh + C::kTile;
  unsigned char* dhh = sm + C::gs;                 // d_h over the g stage
  unsigned char* dhl = dhh + C::kTile;
  const uint32_t s0 = smem_u32(sm);
  const uint32_t u_w1h = s0 + C::w1h, u_w1l = s0 + C::w1l;
  const uint32_t u_w2h = s0 + C::w2h, u_w2l = s0 + C::w2l;
  const uint32_t u_gah = s0 + C::gah, u_gal = s0 + C::gal;
  const uint32_t u_ach = s0 + C::ach, u_acl = s0 + C::acl;
  const uint32_t u_dyh = smem_u32(dyh), u_dyl = smem_u32(dyl);
  const uint32_t u_dhh = smem_u32(dhh), u_dhl = smem_u32(dhl);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warpgroup(), wq = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int G = p.g, K = p.k, N = p.n;
  const int c0 = wg * NH;              // this warpgroup's first column

  // The weights, split once: w1 [kGP rows][WP], w2 [WP][WP], zero-padded.
  for (int e = tid; e < kGP * WP; e += kThreads) {
    const int r = e / WP, c = e % WP;
    store_split1(sm + C::w1h, sm + C::w1l, sw_off(r, c, kGP),
                 r < G && c < W ? w1[r * W + c] : 0.f);
  }
  for (int e = tid; e < WP * WP; e += kThreads) {
    const int r = e / WP, c = e % WP;
    store_split1(sm + C::w2h, sm + C::w2l, sw_off(r, c, WP),
                 r < W && c < W ? w2[r * W + c] : 0.f);
  }
  for (int e = tid; e < WP; e += kThreads) {
    b1s[e] = e < W ? b1[e] : 0.f;
    b2s[e] = e < W ? b2[e] : 0.f;
  }
  for (int e = tid; e < kGP; e += kThreads) cen[e] = e < G ? centers[e] : 0.f;
  fence_async_smem();
  __syncthreads();

  for (int i = blockIdx.x; i < N; i += gridDim.x) {
    const size_t rowk = (size_t)i * K;
    for (int e = tid; e < WP; e += kThreads)
      gc[e] = e < W ? gout[(size_t)i * W + e] : 0.f;
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
      for (int w = 0; w < kThreads / 32; ++w) count += wc[w];
      __syncthreads();
    }

    float dxs[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) dxs[s] = 0.f;

    // Thread q < T loads lane, neighbor and distance of pair q of the next
    // tile a tile ahead, so their latency overlaps the tile before.
    int nl = -1, nj = -1;
    float nd = 0.f;
    auto fetch = [&](int q) {
      nl = -1;
      if (tid < kT && q < count) {
        nl = list[q];
        nj = idx[rowk + nl];
        nd = dist[rowk + nl];
      }
    };
    fetch(tid);
    for (int t0 = 0; t0 < count; t0 += kT) {
      // (a) The tile's pairs: lane, neighbor, distance, cutoff terms.
      if (tid < kT) {
        int j = -1;
        float d = 0.f, fc = 0.f, dfc = 0.f;
        if (nl >= 0) {
          j = nj < 0 || nj >= N ? -1 : nj;  // the padding row: zero vectors
          d = nd;
          float s, c;
          __sincosf(p.pi_rc * d, &s, &c);
          fc = 0.5f * c + 0.5f;
          dfc = -0.5f * p.pi_rc * s;
        }
        pj[tid] = j;
        pl[tid] = nl;
        pd[tid] = d;
        pfc[tid] = fc;
        pdfc[tid] = dfc;
        fetch(t0 + kT + tid);
      }
      __syncthreads();
      // Gather x[j] and g[j] into the stage (zeros for empty slots and
      // padded columns); they land while the h and y1 products run.
      // A thread copies one 16-byte column piece of every QS-th pair.
      {
        constexpr int CH = WP / 4, QS = kThreads / CH;
        const int c = 4 * (tid % CH), qa = tid / CH;
#pragma unroll
        for (int k = 0; k < kT / QS; ++k) {
          const int q = qa + QS * k, j = pj[q];
          const bool ok = c < W && j >= 0;
          const size_t off = ok ? (size_t)j * W + c : 0;
          cp_async16(xs + q * XS + c, x + off, ok);
          cp_async16(gs + q * XS + c, gout + off, ok);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      // (b) Gaussians, split (0 for empty slots and padded columns): a
      // thread takes one Gaussian column of every fourth pair.
      {
        const int gg = tid % kGP, qa = tid / kGP;
        const float cg = cen[gg];
#pragma unroll 4
        for (int k = 0; k < kT / (kThreads / kGP); ++k) {
          const int q = qa + (kThreads / kGP) * k;
          const float u = (pd[q] - cg) * p.inv_gw;
          const float v = gg < G && pl[q] >= 0 ? fast_exp(-0.5f * u * u) : 0.f;
          store_split1(sm + C::gah, sm + C::gal, sw_off(q, gg, kT), v);
        }
      }
      fence_async_smem();
      __syncthreads();

      // (c) h = gauss w1 + b1 -> act (hi/lo tile), act' (registers).
      float acc[NA], actd[NA];
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[v] = 0.f;
      wgmma_fence();
      gemm3<0, 1, NH, kGP / 16>(acc, u_gah, u_gal, kT, 0, u_w1h, u_w1l, kGP,
                                c0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq;
          const float2 bias = *reinterpret_cast<const float2*>(b1s + c);
          float a2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = 4 * jj + 2 * h + e;
            const float hv = acc[v] + (e ? bias.y : bias.x);
            if constexpr (TANH) {
              a2[e] = tanhf(hv);
              actd[v] = 1.f - a2[e] * a2[e];
            } else {
              const float z = fast_exp(-fabsf(hv));    // shared exp(-|h|)
              a2[e] = fmaxf(hv, 0.f) + fast_log(1.f + z) - kLn2;
              actd[v] = (hv >= 0.f ? 1.f : z) * fast_rcp(1.f + z);
            }
          }
          store_split(sm + C::ach, sm + C::acl, sw_off(r, c, kT), a2[0],
                      a2[1]);
        }
      fence_async_smem();
      __syncthreads();

      // (d) y1 = act w2 + b2; with the gathered rows: d_y1, d_fc, d_x.
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[v] = 0.f;
      wgmma_fence();
      gemm3<0, 1, NH, KW>(acc, u_ach, u_acl, kT, 0, u_w2h, u_w2l, WP, c0);
      wgmma_commit();
      wgmma_wait<0>();
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      {
        float cs[NV], dfc2[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NV; ++q) cs[q] = 0.f;
#pragma unroll
        for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq;
            const float fc = pfc[r];
            const float2 xv = *reinterpret_cast<const float2*>(xs + r * XS + c);
            const float2 gv = *reinterpret_cast<const float2*>(gs + r * XS + c);
            const float2 bias = *reinterpret_cast<const float2*>(b2s + c);
            const float2 gi = *reinterpret_cast<const float2*>(gc + c);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int v = 4 * jj + 2 * h + e;
              const float y = acc[v] + (e ? bias.y : bias.x);
              const float t = (e ? gi.y : gi.x) * (e ? xv.y : xv.x);
              dfc2[h] = fmaf(t, y, dfc2[h]);
              cs[2 * jj + e] = fmaf(y * fc, e ? gv.y : gv.x, cs[2 * jj + e]);
              acc[v] = t * fc;                          // d_y1
            }
          }
        reduce_scatter<NV>(cs, lane);
#pragma unroll
        for (int s = 0; s < NS; ++s) dxs[s] += cs[s];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = dfc2[h];
          s += __shfl_xor_sync(kFull, s, 1);
          s += __shfl_xor_sync(kFull, s, 2);
          if (tq == 0) sdfc[wg * kT + 16 * wq + gq + 8 * h] = s;
        }
      }
      __syncthreads();                 // the x stage is read: d_y1 over it
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq;
          store_split(dyh, dyl, sw_off(r, c, kT), acc[4 * jj + 2 * h],
                      acc[4 * jj + 2 * h + 1]);
        }
      fence_async_smem();
      __syncthreads();

      // (e) d_act = d_y1 w2^T -> d_h = d_act act'.
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[v] = 0.f;
      wgmma_fence();
      gemm3<0, 0, NH, KW>(acc, u_dyh, u_dyl, kT, 0, u_w2h, u_w2l, WP, c0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[v] *= actd[v];          // d_h
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + gq + 8 * h, c = c0 + 8 * jj + 2 * tq;
          store_split(dhh, dhl, sw_off(r, c, kT), acc[4 * jj + 2 * h],
                      acc[4 * jj + 2 * h + 1]);
        }
      fence_async_smem();
      __syncthreads();

      // (f) d_gauss = d_h w1^T -> d_dist.
      {
        float ag[16];
#pragma unroll
        for (int v = 0; v < 16; ++v) ag[v] = 0.f;
        wgmma_fence();
        gemm3<0, 0, 32, KW>(ag, u_dhh, u_dhl, kT, 0, u_w1h, u_w1l, kGP,
                            32 * wg);
        wgmma_commit();
        wgmma_wait<0>();
        float s2[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wq + gq + 8 * h;
            // Columns gg >= G hold exact zeros (w1's padded rows are 0).
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int gg = 32 * wg + 8 * jj + 2 * tq + e;
              const float u = (pd[r] - cen[gg]) * p.inv_gw;
              s2[h] = fmaf(ag[4 * jj + 2 * h + e] * fast_exp(-0.5f * u * u),
                           -u * p.inv_gw, s2[h]);
            }
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = s2[h];
          s += __shfl_xor_sync(kFull, s, 1);
          s += __shfl_xor_sync(kFull, s, 2);
          if (tq == 0) sdd[wg * kT + 16 * wq + gq + 8 * h] = s;
        }
      }
      __syncthreads();
      if (tid < kT && pl[tid] >= 0)
        d_dist[rowk + pl[tid]] = (sdd[tid] + sdd[kT + tid]) +
                                 (sdfc[tid] + sdfc[kT + tid]) * pdfc[tid];
    }

    // The row's d_x: the warps' column sums, added in warp order.
#pragma unroll
    for (int s = 0; s < NS; ++s)
      red[warp * WP + c0 + col_of(gq * NS + s, tq)] = dxs[s];
    __syncthreads();
    for (int e = tid; e < W; e += kThreads) {
      const int w0 = 4 * (e / NH);
      float s = 0.f;
      for (int w = 0; w < 4; ++w) s += red[(w0 + w) * WP + e];
      d_x[(size_t)i * W + e] = s;
    }
    __syncthreads();
  }
}

template <int W>
int launch_forces(const float* dist, const uint8_t* mask, const int* idx,
                  const float* x, const float* gout, const float* w1,
                  const float* b1, const float* w2, const float* b2,
                  const float* centers, float* d_dist, float* d_x,
                  int nblocks, bool tanh_act, const Params& p,
                  cudaStream_t stream) {
  const int smem = Carve<W>::bytes(p.k);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const auto kernel = tanh_act ? cfconv_bwd_forces_kernel<W, true>
                               : cfconv_bwd_forces_kernel<W, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblocks, kThreads, smem, stream>>>(dist, mask, idx, x, gout, w1,
                                              b1, w2, b2, centers, d_dist,
                                              d_x, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dist [n, k] f32, mask [n, k] u8, idx [n, k] i32 (n = padding), x and
// gout [n, width] f32 (16-byte aligned), w1 [g, width], b1 [width], w2
// [width, width], b2 [width], centers [g] f32. Outputs: d_dist [n, k], d_x
// [n, width], dw [g*width + width + width*width + width] (dW1 | db1 | dW2 |
// db2), with scratch part [nblocks, that size].
int cfconv_bwd(const float* dist, const uint8_t* mask, const int* idx,
               const float* x, const float* gout, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* centers, float* d_dist, float* d_x, float* part,
               float* dw, int n, int k, int width, int g, int nblocks,
               int tanh_act, double inv_gw, double pi_rc, void* stream) {
  if (n < 1 || k < 1 || g < 1 || g > kGP || nblocks < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gout)) % 16)
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
      return launch<32>(dist, mask, idx, x, gout, w1, b1, w2, b2, centers,
                        d_dist, d_x, part, dw, n, k, g, nblocks, tanh_act,
                        p, s);
    case 64:
      return launch<64>(dist, mask, idx, x, gout, w1, b1, w2, b2, centers,
                        d_dist, d_x, part, dw, n, k, g, nblocks, tanh_act,
                        p, s);
    case 128:
      return launch<128>(dist, mask, idx, x, gout, w1, b1, w2, b2, centers,
                         d_dist, d_x, part, dw, n, k, g, nblocks, tanh_act,
                         p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As cfconv_bwd without the weight gradients (and so without part and
// dw): d_dist [n, k] and d_x [n, width], one launch.
int cfconv_bwd_forces(const float* dist, const uint8_t* mask, const int* idx,
                      const float* x, const float* gout, const float* w1,
                      const float* b1, const float* w2, const float* b2,
                      const float* centers, float* d_dist, float* d_x, int n,
                      int k, int width, int g, int nblocks, int tanh_act,
                      double inv_gw, double pi_rc, void* stream) {
  if (n < 1 || k < 1 || g < 1 || g > kGP || nblocks < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gout)) % 16)
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
      return launch_forces<32>(dist, mask, idx, x, gout, w1, b1, w2, b2,
                               centers, d_dist, d_x, nblocks, tanh_act, p, s);
    case 64:
      return launch_forces<64>(dist, mask, idx, x, gout, w1, b1, w2, b2,
                               centers, d_dist, d_x, nblocks, tanh_act, p, s);
    case 128:
      return launch_forces<128>(dist, mask, idx, x, gout, w1, b1, w2, b2,
                                centers, d_dist, d_x, nblocks, tanh_act, p,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
