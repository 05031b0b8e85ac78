// Fused species ensemble for sm_90a: the M-model CELU(0.1) MLP of every
// species, energy (fwd) or energy and input gradient (fwdgrad), as one set
// of launches for all species.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_nn.py:54
// make_fused_species_net: fwd_kernel (:105, pl.pallas_call :183) and
// fwdgrad_kernel (:136, pl.pallas_call :194). Wrapper, weight packing,
// autograd Function and the plain PyTorch version of each stage:
// nnpops_tpu_torch/ops/cuda_nn.py.
//
// Semantics (as the Pallas kernel): per model, z = bf16(h) @ bf16(W)^T with
// f32 accumulation, + b (f32), CELU(0.1) in f32; activations are rounded to
// bf16 only as matmul operands. The out=1 last layer is an f32 product with
// the bf16-valued last weights; the result is the model mean. fwdgrad also
// emits dx = de/dx at unit cotangent; the backward matmuls take bf16
// operands too, and the CELU derivatives stay f32.
//
// What bounds it on the H100: the tensor cores. For the ANI-2x H net the
// first layer is 76 % of the forward MACs (1008 x 256 of 337,920 a row and
// model) and its transpose product, which gives dx, the same share of the
// backward. Across the M models the first layer is one dense product,
// X [n, in] x W1cat^T with W1cat = [W1_1; ...; W1_M] ([M d1, in]), and
// dx = (1/M) sum_m G1_m W1_m is one product with K = M d1, in which the sum
// over models falls into the K accumulation.
//
// Design: three kernels, each one launch for every species of the step; a
// per-launch table (species row ranges, padded widths, weight offsets) is
// passed by value, so a block finds its species from blockIdx alone.
//   layer1 (ens_gemm<0|1>): Z1 = bf16(X) W1cat^T, 128 x 128 output tiles,
//     two warpgroups issuing wgmma m64n128k16 on 64-wide k-tiles that TMA
//     brings into a 3-stage shared-memory ring (128-byte swizzle, mbarrier
//     completion; the ragged K = 1008 is zero-filled by TMA). The epilogue
//     adds the bias, applies CELU in f32 and writes H1 (bf16, the next
//     product's operand) and, for fwdgrad, D1 = CELU'(z) (f32), through
//     shared memory in whole 16-byte pieces.
//   hidden (hidden_kernel): one block per (species, 64-row block, model),
//     two warpgroups of wgmma m64n32k16 that split each layer's columns in
//     32-wide chunks. Layers 2..L-1 run forward, then the energy h . w_last
//     is reduced per row in a fixed order (shuffles, then the two
//     warpgroups) and, for fwdgrad, the backward runs down to
//     G1_m = (c2 W2_m) o D1_m, written bf16. Activations stay in shared
//     memory in the swizzled layout wgmma reads; weight k-tiles stream
//     through a 3-stage cp.async ring in the same layout (the backward
//     reads a packed transposed copy, so both directions are K-major).
//     Hidden derivatives stay in shared memory in the accumulators' thread
//     order (the forward and backward products of one width share it).
//     The last of a row block's M blocks (an integer counter, which it
//     resets) sums the per-model energies in model order.
//   dx (ens_gemm<2>): dx = (1/M) G1cat W1cat as the layer-1 GEMM with
//     K = M d1 over a K-major copy of W1cat, written f32.
// No float atomics: two launches on the same inputs give bitwise equal e
// and dx.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSpecies = 8;
constexpr int kMaxLayers = 8;
constexpr int kMetaHead = 8;     // host table: header ints, then per species
constexpr int kMetaStride = 16;
constexpr float kAlpha = 0.1f;
constexpr float kInvAlpha = 10.f;
constexpr int kSmemLimit = 232448;

// Per-launch species table (built on the host from the packed ensemble's
// table and the call's row counts; passed by value).
struct Table {
  int ns, M, L, in_actual, in_pad, kmax, ksum, maxw, n_total;
  int dwords;              // floats of the hidden derivatives in shared memory
  int rows[kMaxSpecies];   // rows of species s
  int row0[kMaxSpecies];   // first row of species s in X, H1, G1, dx
  int rb0[kMaxSpecies];    // first 64-row block of species s (counters)
  int d[kMaxSpecies][kMaxLayers + 1];   // padded widths; d[L] = 1
  int w1row[kMaxSpecies];  // first row of species s in W1cat (= K offset in W1cat^T)
  int woff[kMaxSpecies];   // bf16 offset of species s's hidden weights in wbuf
  int foff[kMaxSpecies];   // f32 offset of species s's vectors in fbuf
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// CELU(0.1) of z into *h; returns its derivative. exp(z / alpha) is taken as
// __expf(10 z) (ex2.approx, a few ulp), not as the IEEE division and expf
// that cost the epilogues most of their instruction issue.
// The first 1024-byte boundary of dynamic shared memory (the 128-byte
// swizzle repeats every 1024 bytes), kept as an offset from the shared
// array so that the compiler still knows the address space.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// The warpgroup of this thread, as a warp-uniform value: branches on it
// are then not divergent, which would make ptxas serialize the wgmmas.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
}

__device__ __forceinline__ float celu_deriv(float z, float* h) {
  const float ez = __expf(z * kInvAlpha);
  *h = z > 0.f ? z : kAlpha * (ez - 1.f);
  return z > 0.f ? 1.f : ez;
}

// ---------------------------------------------------------------------------
// Stage 1 and 3: wgmma GEMM with a TMA ring.
// ---------------------------------------------------------------------------

constexpr int kGM = 128, kGN = 128, kGK = 64, kGStages = 3;
constexpr int kGThreads = 256;                     // two warpgroups
constexpr int kABytes = kGM * kGK * 2;             // 16 KB
constexpr int kBBytes = kGN * kGK * 2;             // 16 KB
constexpr int kStageBytes = kABytes + kBBytes;     // 32 KB, 1024-aligned
// The epilogue stages its tile in the ring's memory: H1 (bf16) and D1
// (f32), or dx (f32), row strides padded against bank conflicts.
constexpr int kHLd = kGN + 8, kFLd = kGN + 4;
constexpr int kStageOut = kGM * kHLd * 2 + kGM * kFLd * 4;
constexpr int kGSmem = (kGStages * kStageBytes > kStageOut
                            ? kGStages * kStageBytes : kStageOut) + 1024 + 64;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(phase) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// layout TMA writes: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// KIND 0: layer 1 forward (H1), 1: layer 1 with D1, 2: dx.
// C[64, 128] tile of species s: A rows (row0 + 64 mt), B rows or columns as
// set below; K-tiles of 64 through the ring.
template <int KIND>
__global__ void __launch_bounds__(kGThreads)
ens_gemm(const __grid_constant__ CUtensorMap map_a,
         const __grid_constant__ CUtensorMap map_b,
         const __grid_constant__ Table tab, const float* __restrict__ fbuf,
         bf16* __restrict__ h1, float* __restrict__ d1, int* __restrict__ cnt,
         int ncnt, float* __restrict__ dx) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int ring_bytes = kGStages * kStageBytes > kStageOut
                             ? kGStages * kStageBytes : kStageOut;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes);
  const int tid = threadIdx.x;

  if (KIND < 2 && blockIdx.x == 0)
    for (int i = tid; i < ncnt; i += kGThreads) cnt[i] = 0;

  // Which species and tile this block owns.
  int b = blockIdx.x, s = 0, mt = 0, nt = 0;
  for (; s < tab.ns; ++s) {
    const int nm = cdiv(tab.rows[s], kGM);
    const int nn = KIND < 2 ? cdiv(tab.M * tab.d[s][1], kGN)
                            : cdiv(tab.in_actual, kGN);
    if (b < nm * nn) {
      mt = b / nn;
      nt = b % nn;
      break;
    }
    b -= nm * nn;
  }
  if (s == tab.ns) return;
  const int ksp = tab.M * tab.d[s][1];
  const int K = KIND < 2 ? tab.in_pad : ksp;
  const int nk = cdiv(K, kGK);
  const int a_row = tab.row0[s] + mt * kGM;
  const int b_row = KIND < 2 ? tab.w1row[s] + nt * kGN : nt * kGN;
  const int b_k0 = KIND < 2 ? 0 : tab.w1row[s];

  const uint32_t smem_base = smem_u32(smem);
  const uint32_t bar0 = smem_u32(bars);
  if (tid == 0) {
    for (int i = 0; i < kGStages; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* pa = &map_a;
  const CUtensorMap* pb = &map_b;
  auto issue = [&](int kt) {
    const int slot = kt % kGStages;
    const uint32_t sa = smem_base + slot * kStageBytes;
    const uint32_t bar = bar0 + 8 * slot;
    mbar_expect(bar, kStageBytes);
    tma_load_2d(sa, pa, kt * kGK, a_row, bar);
    tma_load_2d(sa + kABytes, pb, b_k0 + kt * kGK, b_row, bar);
  };
  if (tid == 0)
    for (int kt = 0; kt < kGStages && kt < nk; ++kt) issue(kt);

  // Warpgroup wg multiplies A rows 64 wg .. 64 wg + 63 by the whole B tile.
  const int wg = warpgroup();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % kGStages;
    mbar_wait(bar0 + 8 * slot, (kt / kGStages) & 1);
    const uint32_t sa = smem_base + slot * kStageBytes;
    const uint64_t da = sw128_desc(sa + wg * (kABytes / 2));
    const uint64_t db = sw128_desc(sa + kABytes);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk)
      wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);   // +32 bytes along K
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();   // every warp is done reading this slot
    if (tid == 0 && kt + kGStages < nk) issue(kt + kGStages);
  }

  // Epilogue. Fragment of m64nN: warp w of the warpgroup, lane 4g + t holds
  // rows 16w + g (+8) at columns 8j + 2t, 8j + 2t + 1 in acc[4j + 2h + {0,
  // 1}]. The tile goes through shared memory (the ring, now idle) so that
  // device memory is written in whole 16-byte pieces along rows.
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rows = tab.rows[s];
  const int rows_here = min(kGM, rows - mt * kGM);
  const size_t grow0 = (size_t)(tab.row0[s] + mt * kGM);
  bf16* sh = reinterpret_cast<bf16*>(smem);                       // [kGM][kHLd]
  float* sf = reinterpret_cast<float*>(smem + kGM * kHLd * 2);    // [kGM][kFLd]
  if (KIND < 2) {
    const int ncols = min(kGN, ksp - nt * kGN);                   // multiple of 64
    float2 bias[kGN / 8];
#pragma unroll
    for (int j = 0; j < kGN / 8; ++j) {
      const int c = nt * kGN + 8 * j + 2 * t;
      bias[j] = c < ksp ? *reinterpret_cast<const float2*>(fbuf + tab.foff[s] + c)
                        : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kGN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + g + 8 * h, c = 8 * j + 2 * t;
        float y0, y1;
        const float q0 = celu_deriv(acc[4 * j + 2 * h] + bias[j].x, &y0);
        const float q1 = celu_deriv(acc[4 * j + 2 * h + 1] + bias[j].y, &y1);
        *reinterpret_cast<__nv_bfloat162*>(sh + r * kHLd + c) =
            __floats2bfloat162_rn(y0, y1);
        if (KIND == 1)
          *reinterpret_cast<float2*>(sf + r * kFLd + c) = make_float2(q0, q1);
      }
    __syncthreads();
    const int hchunks = ncols / 8;
    for (int i = tid; i < kGM * hchunks; i += kGThreads) {
      const int r = i / hchunks, c = 8 * (i % hchunks);
      if (r < rows_here)
        *reinterpret_cast<uint4*>(h1 + (grow0 + r) * tab.kmax + nt * kGN + c) =
            *reinterpret_cast<const uint4*>(sh + r * kHLd + c);
    }
    if (KIND == 1) {
      const int fchunks = ncols / 4;
      for (int i = tid; i < kGM * fchunks; i += kGThreads) {
        const int r = i / fchunks, c = 4 * (i % fchunks);
        if (r < rows_here)
          *reinterpret_cast<float4*>(d1 + (grow0 + r) * tab.kmax + nt * kGN + c) =
              *reinterpret_cast<const float4*>(sf + r * kFLd + c);
      }
    }
  } else {
    const float inv_m = 1.f / (float)tab.M;
#pragma unroll
    for (int j = 0; j < kGN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + g + 8 * h, c = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(sf + r * kFLd + c) = make_float2(
            acc[4 * j + 2 * h] * inv_m, acc[4 * j + 2 * h + 1] * inv_m);
      }
    __syncthreads();
    const int ncols = min(kGN, tab.in_actual - nt * kGN);
    const bool vec4 = tab.in_actual % 4 == 0;
    for (int i = tid; i < kGM * (kGN / 4); i += kGThreads) {
      const int r = i / (kGN / 4), c = 4 * (i % (kGN / 4));
      if (r >= rows_here || c >= ncols) continue;
      float* out = dx + (grow0 + r) * tab.in_actual + nt * kGN + c;
      const float* src = sf + r * kFLd + c;
      if (vec4) {
        *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int e = 0; e < 4 && c + e < ncols; ++e) out[e] = src[e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Stage 2: the hidden layers per (species, 64-row block, model).
// ---------------------------------------------------------------------------

constexpr int kHRows = 64;
constexpr int kHThreads = 256;            // two warpgroups
constexpr int kHK = 64;                   // weight k-tile (one 128-byte row)
constexpr int kHStages = 3;
constexpr int kMaxW = 256;                // widest hidden layer
constexpr int kChunk = 32;                // output columns of one wgmma
constexpr int kMaxChunks = kMaxW / kChunk / 2;   // chunks a warpgroup owns
constexpr int kSlotBytes = kMaxW * kHK * 2;      // 32 KB: [N][64] bf16
constexpr int kRingBytes = kHStages * kSlotBytes;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes (stores, cp.async) visible to
// the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Byte offset of element (r, c) of a [64, K] bf16 operand in the 128-byte
// swizzle layout, K-major: 64-column blocks of 8 KB, rows of 128 bytes, the
// 16-byte pieces of row r permuted by r mod 8 (what TMA writes for a
// [64, 64] box, and what the wgmma descriptor of sw128_desc reads).
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return (c >> 6) * (kHRows * 128) + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// acc = A [64, K] (bf16 in shared memory, 128-byte swizzle) x W^T with W
// [N, K] bf16 in device memory (row-major: the forward weight [out, in], or
// for the backward the transposed copy). N is a multiple of 32 and split in
// 32-column chunks: warpgroup wg owns chunks wg, wg + 2, ... Weight k-tiles
// of 64 stream through a cp.async ring in the same swizzled layout.
__device__ __forceinline__ void hidden_gemm(uint32_t a_base,
                                            const bf16* __restrict__ W, int N,
                                            int K, unsigned char* ring,
                                            float (&acc)[kMaxChunks][16]) {
  const int tid = threadIdx.x, wg = warpgroup();
  const int nchunks = N / kChunk, mine = (nchunks - wg + 1) / 2;
  const int ntiles = cdiv(K, kHK);
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i)
#pragma unroll
    for (int v = 0; v < 16; ++v) acc[i][v] = 0.f;

  auto load = [&](int kt) {
    if (kt < ntiles) {
      unsigned char* dst = ring + (kt % kHStages) * kSlotBytes;
      const int k0 = kt * kHK, pieces = min(kHK, K - k0) / 8;
      for (int i = tid; i < N * pieces; i += kHThreads) {
        const int n = i / pieces, p = i % pieces;
        cp_async16(dst + n * 128 + ((p ^ (n & 7)) << 4),
                   W + (size_t)n * K + k0 + 8 * p);
      }
    }
    cp_commit();
  };

  for (int kt = 0; kt < kHStages - 1; ++kt) load(kt);
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_wait<kHStages - 2>();
    fence_async_smem();
    __syncthreads();   // tile kt is in; every warpgroup is done with kt - 1
    load(kt + kHStages - 1);
    const uint32_t b_base = smem_u32(ring + (kt % kHStages) * kSlotBytes);
    const int steps = min(kHK, K - kt * kHK) / 16;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int ks = 0; ks < steps; ++ks) {
      const uint64_t da = sw128_desc(a_base + kt * (kHRows * 128)) + 2 * ks;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < mine)
          wgmma_m64n32k16(acc[i], da,
                          sw128_desc(b_base + (wg + 2 * i) * kChunk * 128) +
                              2 * ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  cp_wait<0>();
}

// Buffers of species s (built by cuda_nn.pack_ensemble), M models, widths d:
//   wbuf + woff: for l = 1 .. L-2: W_l [M, d[l+1], d[l]], then its
//                transpose W_l^T [M, d[l], d[l+1]] (bf16)
//   fbuf + foff: b1cat [M d1] (column m d1 + j of H1); for l = 1 .. L-2:
//                b_l [M, d[l+1]]; w_last [M, d[L-1]] (bf16-rounded); b_last [M]
// Thread layout of a [64, N] result: warpgroup wg, warp q of it, lane
// 4g + t hold, for each chunk i it owns (columns 32 (wg + 2i) + 8j + 2t + e,
// j < 4, e < 2) rows 16q + g and 16q + g + 8 in acc[i][4j + 2h + e]. The
// forward and backward products of one width share it, so a derivative is
// kept in this thread order (dsm) and read back by the thread that wrote it.
template <bool GRAD>
__global__ void __launch_bounds__(kHThreads, 1)
hidden_kernel(const __grid_constant__ Table tab, const bf16* __restrict__ h1,
              const float* __restrict__ d1, const bf16* __restrict__ wbuf,
              const float* __restrict__ fbuf, bf16* __restrict__ g1,
              float* __restrict__ epart, int* __restrict__ cnt,
              float* __restrict__ e_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, wg = warpgroup(), tw = tid & 127;
  const int q = tw >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int M = tab.M, L = tab.L;

  int b = blockIdx.x, s = 0;
  for (; s < tab.ns; ++s) {
    const int units = cdiv(tab.rows[s], kHRows) * M;
    if (b < units) break;
    b -= units;
  }
  if (s == tab.ns) return;
  const int rb = b / M, m = b % M;
  const int* d = tab.d[s];
  const int rows_here = min(kHRows, tab.rows[s] - rb * kHRows);
  const int grow0 = tab.row0[s] + rb * kHRows;

  const int act_bytes = kHRows * 128 * cdiv(tab.maxw, 64);
  unsigned char* ring = smem;
  unsigned char* act0 = smem + kRingBytes;
  unsigned char* act1 = act0 + act_bytes;
  float* red = reinterpret_cast<float*>(act1 + act_bytes);   // [2][64]
  float* dsm = red + 2 * kHRows;       // hidden derivatives, thread order
  float* vec = dsm + tab.dwords;       // model m's biases and w_last
  __shared__ int last_flag;

  // Offsets of this species' layers.
  size_t woff[kMaxLayers];
  int boff[kMaxLayers], doff[kMaxLayers], voff[kMaxLayers];
  {
    size_t wo = tab.woff[s];
    int fo = tab.foff[s] + M * d[1], dof = 0;
    for (int l = 1; l <= L - 2; ++l) {
      woff[l] = wo;
      wo += 2 * (size_t)M * d[l + 1] * d[l];
      boff[l] = fo;
      fo += M * d[l + 1];
      doff[l + 1] = dof;
      if (l + 1 <= L - 2) dof += kHRows * d[l + 1];
    }
    boff[0] = fo;   // w_last, then b_last
    // Model m's vectors: b_l at vec + voff[l], w_last at vec + voff[0].
    int vo = 0;
    for (int l = 1; l <= L - 2; ++l) {
      voff[l] = vo;
      for (int i = tid; i < d[l + 1]; i += kHThreads)
        vec[vo + i] = fbuf[boff[l] + m * d[l + 1] + i];
      vo += d[l + 1];
    }
    voff[0] = vo;
    for (int i = tid; i < d[L - 1]; i += kHThreads)
      vec[vo + i] = fbuf[boff[0] + m * d[L - 1] + i];
  }
  const float* wl = vec + voff[0];

  // This block's H1 rows, model m's columns, swizzled; rows past the
  // species are 0.
  {
    const int pieces = d[1] / 8;
    for (int i = tid; i < kHRows * pieces; i += kHThreads) {
      const int r = i / pieces, p = i % pieces;
      unsigned char* dst = act0 + sw128_offset(r, 8 * p);
      if (r < rows_here)
        cp_async16(dst, h1 + (size_t)(grow0 + r) * tab.kmax + m * d[1] + 8 * p);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_commit();
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();
  }

  float acc[kMaxChunks][16];
  float pe[2] = {0.f, 0.f};
  unsigned char* cur = act0;
  unsigned char* nxt = act1;
  for (int l = 1; l <= L - 2; ++l) {
    const int N = d[l + 1], mine = (N / kChunk - wg + 1) / 2;
    hidden_gemm(smem_u32(cur), wbuf + woff[l] + (size_t)m * N * d[l], N, d[l],
                ring, acc);
    const float* bias = vec + voff[l];
    const bool last = l == L - 2;
    float* dl = dsm + doff[l + 1];
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      if (i >= mine) continue;
      const int c0 = kChunk * (wg + 2 * i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float qv[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = c0 + 8 * j + 2 * t + (v & 1);
          float hv;
          qv[v] = celu_deriv(acc[i][4 * j + v] + bias[c], &hv);
          acc[i][4 * j + v] = hv;
          if (last) {
            pe[v >> 1] += hv * wl[c];
            qv[v] *= wl[c];          // cotangent of the last hidden layer
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * q + g + 8 * h, c = c0 + 8 * j + 2 * t;
          const float v0 = last ? qv[2 * h] : acc[i][4 * j + 2 * h];
          const float v1 = last ? qv[2 * h + 1] : acc[i][4 * j + 2 * h + 1];
          if (!last || GRAD)
            *reinterpret_cast<__nv_bfloat162*>(nxt + sw128_offset(r, c)) =
                __floats2bfloat162_rn(v0, v1);
        }
        if (!last && GRAD)
          *reinterpret_cast<float4*>(
              dl + (((wg + 2 * i) * 4 + j) * 128 + tw) * 4) =
              make_float4(qv[0], qv[1], qv[2], qv[3]);
      }
    }
    fence_async_smem();
    __syncthreads();
    unsigned char* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // Row energies of model m in a fixed order: each thread's columns, the
  // quad's four threads, then the two warpgroups.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pe[h] += __shfl_xor_sync(0xffffffffu, pe[h], 1);
    pe[h] += __shfl_xor_sync(0xffffffffu, pe[h], 2);
  }
  if (t == 0) {
    red[wg * kHRows + 16 * q + g] = pe[0];
    red[wg * kHRows + 16 * q + g + 8] = pe[1];
  }
  __syncthreads();
  if (tid < rows_here)
    epart[(size_t)m * tab.n_total + grow0 + tid] = red[tid] + red[kHRows + tid];
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_flag = atomicAdd(&cnt[tab.rb0[s] + rb], 1) == M - 1;
  __syncthreads();
  if (last_flag) {
    // The last of the row block's M blocks: sum the models in order.
    __threadfence();
    if (tid < rows_here) {
      const float* blast = fbuf + boff[0] + M * d[L - 1];
      float sum = 0.f, bsum = 0.f;
      for (int mm = 0; mm < M; ++mm) {
        sum += __ldcg(epart + (size_t)mm * tab.n_total + grow0 + tid);
        bsum += blast[mm];
      }
      e_out[grow0 + tid] = (sum + bsum) / (float)M;
    }
    if (tid == 0) cnt[tab.rb0[s] + rb] = 0;   // ready for the next launch
  }

  // Backward: c_l = (c_{l+1} W_l) o D_l, from l = L-2 down to 1, with the
  // transposed weights as the K-major operand; D_1 comes from device
  // memory and the result G1 goes there through shared memory.
  for (int l = L - 2; GRAD && l >= 1; --l) {
    const int N = d[l], mine = (N / kChunk - wg + 1) / 2;
    hidden_gemm(smem_u32(cur),
                wbuf + woff[l] + (size_t)M * d[l + 1] * N +
                    (size_t)m * N * d[l + 1],
                N, d[l + 1], ring, acc);
    // D1 for the last product's epilogue, all loads issued before any use.
    float2 dq[kMaxChunks][4][2];
    if (l == 1) {
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * q + g + 8 * h;
            const int c = kChunk * (wg + 2 * i) + 8 * j + 2 * t;
            dq[i][j][h] =
                i < mine && r < rows_here
                    ? *reinterpret_cast<const float2*>(
                          d1 + (size_t)(grow0 + r) * tab.kmax + m * d[1] + c)
                    : make_float2(0.f, 0.f);
          }
    }
    const float* dl = dsm + doff[l];
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      if (i >= mine) continue;
      const int c0 = kChunk * (wg + 2 * i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 qd;
        if (l >= 2)
          qd = *reinterpret_cast<const float4*>(
              dl + (((wg + 2 * i) * 4 + j) * 128 + tw) * 4);
        else
          qd = make_float4(dq[i][j][0].x, dq[i][j][0].y, dq[i][j][1].x,
                           dq[i][j][1].y);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * q + g + 8 * h, c = c0 + 8 * j + 2 * t;
          const float q0 = h ? qd.z : qd.x, q1 = h ? qd.w : qd.y;
          *reinterpret_cast<__nv_bfloat162*>(nxt + sw128_offset(r, c)) =
              __floats2bfloat162_rn(acc[i][4 * j + 2 * h] * q0,
                                    acc[i][4 * j + 2 * h + 1] * q1);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    if (l == 1) {
      // G1 rows of model m, 16 bytes at a time along each row.
      const int pieces = d[1] / 8;
      for (int i = tid; i < kHRows * pieces; i += kHThreads) {
        const int r = i / pieces, p = i % pieces;
        if (r < rows_here)
          *reinterpret_cast<uint4*>(g1 + (size_t)(grow0 + r) * tab.kmax +
                                    m * d[1] + 8 * p) =
              *reinterpret_cast<const uint4*>(nxt + sw128_offset(r, 8 * p));
      }
    }
    unsigned char* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Host table of a packed ensemble (cuda_nn.pack_ensemble):
//   [0] species, [1] models M, [2] linear layers L, [3] in_actual,
//   [4] in_pad, [5] kmax, [6] ksum, [7] widest hidden layer; then per
//   species s at kMetaHead + kMetaStride s: d[0..L] (padded), [9] w1row,
//   [10] woff, [11] foff.
int read_table(const int* meta, const int* counts, Table* t) {
  t->ns = meta[0];
  t->M = meta[1];
  t->L = meta[2];
  t->in_actual = meta[3];
  t->in_pad = meta[4];
  t->kmax = meta[5];
  t->ksum = meta[6];
  t->maxw = meta[7];
  t->dwords = 0;
  if (t->ns < 1 || t->ns > kMaxSpecies || t->M < 1 || t->L < 3 ||
      t->L > kMaxLayers || t->in_pad % 8 != 0 || t->in_actual > t->in_pad)
    return (int)cudaErrorInvalidValue;
  int row = 0, rb = 0;
  for (int s = 0; s < t->ns; ++s) {
    const int* ms = meta + kMetaHead + kMetaStride * s;
    for (int l = 0; l <= t->L; ++l) t->d[s][l] = ms[l];
    for (int l = 1; l < t->L; ++l)
      if (ms[l] <= 0 || ms[l] % kChunk != 0 || ms[l] > kMaxW ||
          ms[l] > t->maxw)
        return (int)cudaErrorInvalidValue;
    if ((t->M * ms[1]) % kGK != 0 || t->M * ms[1] > t->kmax)
      return (int)cudaErrorInvalidValue;
    t->w1row[s] = ms[9];
    t->woff[s] = ms[10];
    t->foff[s] = ms[11];
    if (ms[11] % 4 != 0) return (int)cudaErrorInvalidValue;   // float4 loads
    if (counts[s] < 0) return (int)cudaErrorInvalidValue;
    t->rows[s] = counts[s];
    t->row0[s] = row;
    t->rb0[s] = rb;
    row += counts[s];
    rb += cdiv(counts[s], kHRows);
  }
  t->n_total = row;
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 row-major [outer, inner] matrix as TMA boxes of [box_outer, 64]
// in the 128-byte swizzle; reads past either edge fill zeros.
int encode(CUtensorMap* map, const void* ptr, int inner, int outer,
           int box_outer) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kGK, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Raises a kernel's dynamic shared-memory limit to ``bytes`` where the
// limit set so far on this device (``limit``, the kernel's own) is lower:
// one attribute call per kernel and device, not one per launch.
constexpr int kMaxDevices = 32;

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && limit[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left for the next launch's check
    return (int)err;
  }
  if (known) limit[dev] = bytes;
  return 0;
}

template <int KIND>
int launch_gemm(const Table& t, const CUtensorMap& ma, const CUtensorMap& mb,
                const float* fbuf, bf16* h1, float* d1, int* cnt, int ncnt,
                float* dx, cudaStream_t stream) {
  int grid = 0;
  for (int s = 0; s < t.ns; ++s)
    grid += cdiv(t.rows[s], kGM) *
            (KIND < 2 ? cdiv(t.M * t.d[s][1], kGN) : cdiv(t.in_actual, kGN));
  if (grid == 0) return 0;
  static int limit[kMaxDevices] = {};
  const int err = allow_smem(ens_gemm<KIND>, kGSmem, limit);
  if (err) return err;
  ens_gemm<KIND><<<grid, kGThreads, kGSmem, stream>>>(ma, mb, t, fbuf, h1, d1,
                                                      cnt, ncnt, dx);
  return (int)cudaGetLastError();
}

template <bool GRAD>
int layer1(const void* x16, const void* w1cat, const float* fbuf, void* h1,
           float* d1, int* cnt, int ncnt, const int* meta, const int* counts,
           void* stream) {
  Table t;
  int err = read_table(meta, counts, &t);
  if (err || t.n_total == 0) return err;
  CUtensorMap ma, mb;
  if ((err = encode(&ma, x16, t.in_pad, t.n_total, kGM))) return err;
  if ((err = encode(&mb, w1cat, t.in_pad, t.ksum, kGN))) return err;
  return launch_gemm<GRAD ? 1 : 0>(t, ma, mb, fbuf, (bf16*)h1, d1, cnt, ncnt,
                                   nullptr, (cudaStream_t)stream);
}

template <bool GRAD>
int hidden(const void* h1, const float* d1, const void* wbuf,
           const float* fbuf, void* g1, float* epart, int* cnt, float* e_out,
           const int* meta, const int* counts, void* stream) {
  Table t;
  int err = read_table(meta, counts, &t);
  if (err || t.n_total == 0) return err;
  int grid = 0, dmax = 0;
  for (int s = 0; s < t.ns; ++s) {
    grid += cdiv(t.rows[s], kHRows) * t.M;
    int dbytes = 0;
    for (int l = 2; l <= t.L - 2; ++l) dbytes += kHRows * t.d[s][l] * 4;
    dmax = dbytes > dmax ? dbytes : dmax;
  }
  int vmax = 0;
  for (int s = 0; s < t.ns; ++s) {
    int v = t.d[s][t.L - 1];
    for (int l = 2; l <= t.L - 1; ++l) v += t.d[s][l];
    vmax = v > vmax ? v : vmax;
  }
  t.dwords = dmax / 4;
  const size_t smem = 1024 + (size_t)kRingBytes +
                      2 * (size_t)kHRows * 128 * cdiv(t.maxw, 64) +
                      2 * kHRows * 4 + dmax + 4 * (size_t)vmax;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  static int limit[kMaxDevices] = {};
  if ((err = allow_smem(hidden_kernel<GRAD>, (int)smem, limit))) return err;
  hidden_kernel<GRAD><<<grid, kHThreads, smem, (cudaStream_t)stream>>>(
      t, (const bf16*)h1, d1, (const bf16*)wbuf, fbuf, (bf16*)g1, epart, cnt,
      e_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_nn_fwd_layer1(const void* x16, const void* w1cat, const float* fbuf,
                        void* h1, float* d1, int* cnt, int ncnt,
                        const int* meta, const int* counts, void* stream) {
  return layer1<false>(x16, w1cat, fbuf, h1, d1, cnt, ncnt, meta, counts,
                       stream);
}

int fused_nn_fwdgrad_layer1(const void* x16, const void* w1cat,
                            const float* fbuf, void* h1, float* d1, int* cnt,
                            int ncnt, const int* meta, const int* counts,
                            void* stream) {
  return layer1<true>(x16, w1cat, fbuf, h1, d1, cnt, ncnt, meta, counts,
                      stream);
}

int fused_nn_fwd_hidden(const void* h1, const float* d1, const void* wbuf,
                        const float* fbuf, void* g1, float* epart, int* cnt,
                        float* e_out, const int* meta, const int* counts,
                        void* stream) {
  return hidden<false>(h1, d1, wbuf, fbuf, g1, epart, cnt, e_out, meta,
                       counts, stream);
}

int fused_nn_fwdgrad_hidden(const void* h1, const float* d1, const void* wbuf,
                            const float* fbuf, void* g1, float* epart,
                            int* cnt, float* e_out, const int* meta,
                            const int* counts, void* stream) {
  return hidden<true>(h1, d1, wbuf, fbuf, g1, epart, cnt, e_out, meta,
                      counts, stream);
}

int fused_nn_fwdgrad_dx(const void* g1, const void* w1cat_t, float* dx,
                        const int* meta, const int* counts, void* stream) {
  Table t;
  int err = read_table(meta, counts, &t);
  if (err || t.n_total == 0) return err;
  CUtensorMap ma, mb;
  if ((err = encode(&ma, g1, t.kmax, t.n_total, kGM))) return err;
  if ((err = encode(&mb, w1cat_t, t.ksum, t.in_pad, kGN))) return err;
  return launch_gemm<2>(t, ma, mb, nullptr, nullptr, nullptr, nullptr, 0, dx,
                        (cudaStream_t)stream);
}

}  // extern "C"
