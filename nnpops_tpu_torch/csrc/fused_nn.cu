// Fused species ensemble: 8-model x 4-layer CELU(0.1) MLP per block of atom
// rows, energy (fwd) or energy and input gradient in one pass (fwdgrad),
// for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_nn.py:54
// make_fused_species_net: fwd_kernel (:105) and fwdgrad_kernel (:136).
// Wrapper, weight packing, autograd Function and plain PyTorch version:
// nnpops_tpu_torch/ops/cuda_nn.py.
//
// Semantics (as the Pallas kernel): per model, z = bf16(h) @ bf16(W)^T with
// f32 accumulation, + b (f32), CELU(0.1) in f32; activations stay f32 and
// are rounded to bf16 only as matmul operands. The out=1 last layer is an
// f32 product with the bf16-valued last weights; the result is the model
// mean. fwdgrad also emits dx = de/dx at unit cotangent, reusing each
// exp(z / alpha) for the CELU derivative; the backward matmuls take bf16
// operands too.
//
// What bounds it on the H100: the tensor cores (about 0.68 MFLOP per row
// per model for the ANI-2x H net, twice that with the gradient) and the
// CELU exps. Weights are read from L2 (the ANI-2x H ensemble is ~5.4 MB in
// bf16; the transposed copy for the backward doubles that).
//
// What the simple design does about it: one block of 32 rows (two m16
// tiles) and 8 warps. The row block's inputs sit in shared memory as bf16
// and every hidden activation and backward cotangent stays in shared
// memory (bf16 operands, f32 CELU derivatives), so nothing but x, the
// weights, e and dx touches device memory. Each warp owns 16-column chunks
// of a layer's output and runs mma.sync m16n8k16 bf16 tiles with f32
// accumulators, A fragments from shared memory and B fragments straight
// from the (L2-resident) weights. dx accumulates over models by a plain
// read-modify-write: the same thread owns the same dx elements for every
// model, so no atomics are needed. The energy sum over a row's columns
// uses shared-memory atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;        // rows per block: two m16 tiles
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;          // bf16 row padding (bank-conflict-free A loads)
constexpr int kMaxLayers = 8;
constexpr float kAlpha = 0.1f;

using bf16 = __nv_bfloat16;

struct NetDims {
  int n_layers;              // linear layers; the last has out = 1
  int d[kMaxLayers + 1];     // padded widths: d[0] input, d[n_layers] = 1
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// C[kRows, N] = A[kRows, K] x Bt[N, K]^T, then epi(row, col, value) for
// every element. A: bf16 in shared memory, row stride lda. Bt: bf16 in
// device memory, row-major [N, K] (a torch Linear weight [out, in] for the
// forward, its transpose for the backward). N and K are multiples of 16.
// Fragment layouts are those of PTX mma.m16n8k16 (.row.col): the thread
// with lane = 4 g + t holds A rows g and g+8 at k = 2t, 2t+1, 2t+8, 2t+9,
// B column g at the same k, and C rows g, g+8 at columns 2t, 2t+1.
template <class Epi>
__device__ __forceinline__ void block_gemm(const bf16* A, int lda,
                                           const bf16* __restrict__ Bt, int N,
                                           int K, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int n0 = warp * 16; n0 < N; n0 += kWarps * 16) {
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    const bf16* b0 = Bt + (size_t)(n0 + g) * K + 2 * t;
    const bf16* b1 = b0 + (size_t)8 * K;
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ap = A + (mt * 16 + g) * lda + k0 + 2 * t;
        a[mt][0] = ld_u32(ap);
        a[mt][1] = ld_u32(ap + 8 * lda);
        a[mt][2] = ld_u32(ap + 8);
        a[mt][3] = ld_u32(ap + 8 * lda + 8);
      }
      b[0][0] = ldg_u32(b0 + k0);
      b[0][1] = ldg_u32(b0 + k0 + 8);
      b[1][0] = ldg_u32(b1 + k0);
      b[1][1] = ldg_u32(b1 + k0 + 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          epi(mt * 16 + g + (i >> 1) * 8, n0 + nt * 8 + 2 * t + (i & 1),
              acc[mt][nt][i]);
  }
}

// Buffer layouts (built by cuda_nn.pack_species_net), M models, L layers:
//   wbuf (bf16): for l < L-1: W_l [M, d[l+1], d[l]], then W_l^T [M, d[l], d[l+1]]
//   fbuf (f32):  for l < L-1: b_l [M, d[l+1]]; then w_last [M, d[L-1]]
//                (bf16-rounded values); then b_last [M]
template <bool GRAD>
__global__ void __launch_bounds__(kThreads)
fused_net_kernel(const float* __restrict__ x, const bf16* __restrict__ wbuf,
                 const float* __restrict__ fbuf, float* __restrict__ e_out,
                 float* __restrict__ dx_out, int n, int in_actual,
                 const NetDims nd, int M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = nd.n_layers;
  const int* d = nd.d;
  int maxh = 0;
  for (int l = 1; l < L; ++l) maxh = d[l] > maxh ? d[l] : maxh;
  const int ldx = d[0] + kPad, ldh = maxh + kPad;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* h0 = xs + kRows * ldx;
  bf16* h1 = h0 + kRows * ldh;
  float* erow = reinterpret_cast<float*>(h1 + kRows * ldh);
  float* deriv = erow + kRows;     // GRAD: CELU derivatives of every hidden layer

  size_t woff[kMaxLayers], wtoff[kMaxLayers], boff[kMaxLayers];
  int doff[kMaxLayers];
  size_t wo = 0, bo = 0;
  int dof = 0;
  for (int l = 0; l < L - 1; ++l) {
    woff[l] = wo;
    wo += (size_t)M * d[l + 1] * d[l];
    wtoff[l] = wo;
    wo += (size_t)M * d[l] * d[l + 1];
    boff[l] = bo;
    bo += (size_t)M * d[l + 1];
    doff[l] = dof;
    dof += kRows * d[l + 1];
  }
  const float* wlast_all = fbuf + bo;
  const float* blast = wlast_all + (size_t)M * d[L - 1];

  const int row0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < kRows * d[0]; i += kThreads) {
    const int r = i / d[0], c = i % d[0];
    const int gr = row0 + r;
    const float v = (gr < n && c < in_actual) ? x[(size_t)gr * in_actual + c] : 0.f;
    xs[r * ldx + c] = __float2bfloat16(v);
  }
  if (threadIdx.x < kRows) erow[threadIdx.x] = 0.f;
  __syncthreads();

  const float inv_m = 1.f / (float)M;
  for (int m = 0; m < M; ++m) {
    const float* wl = wlast_all + (size_t)m * d[L - 1];
    const bf16* ain = xs;
    int lda = ldx;
    for (int l = 0; l < L - 1; ++l) {
      const bf16* W = wbuf + woff[l] + (size_t)m * d[l + 1] * d[l];
      const float* b = fbuf + boff[l] + (size_t)m * d[l + 1];
      bf16* hout = (l & 1) ? h1 : h0;
      float* dl = deriv + doff[l];
      const int nout = d[l + 1];
      const bool last = l == L - 2;
      block_gemm(ain, lda, W, nout, d[l], [&](int r, int c, float v) {
        const float z = v + b[c];
        const float ez = expf(z / kAlpha);
        const float h = z > 0.f ? z : kAlpha * (ez - 1.f);
        hout[r * ldh + c] = __float2bfloat16(h);
        if (GRAD) dl[r * nout + c] = z > 0.f ? 1.f : ez;
        if (last) atomicAdd(&erow[r], h * wl[c]);
      });
      __syncthreads();
      ain = hout;
      lda = ldh;
    }
    if (GRAD) {
      // Cotangent of the last hidden layer: w_last * CELU'(z).
      bf16* dcur = h0;
      {
        const int w = d[L - 1];
        const float* dl = deriv + doff[L - 2];
        for (int i = threadIdx.x; i < kRows * w; i += kThreads) {
          const int r = i / w, c = i % w;
          dcur[r * ldh + c] = __float2bfloat16(wl[c] * dl[i]);
        }
      }
      __syncthreads();
      for (int l = L - 2; l >= 1; --l) {
        const bf16* WT = wbuf + wtoff[l] + (size_t)m * d[l] * d[l + 1];
        bf16* dnext = dcur == h0 ? h1 : h0;
        const float* dprev = deriv + doff[l - 1];
        const int w = d[l];
        block_gemm(dcur, ldh, WT, d[l], d[l + 1], [&](int r, int c, float v) {
          dnext[r * ldh + c] = __float2bfloat16(v * dprev[r * w + c]);
        });
        __syncthreads();
        dcur = dnext;
      }
      const bf16* WT0 = wbuf + wtoff[0] + (size_t)m * d[0] * d[1];
      block_gemm(dcur, ldh, WT0, d[0], d[1], [&](int r, int c, float v) {
        const int gr = row0 + r;
        if (gr < n && c < in_actual) {
          float* px = dx_out + (size_t)gr * in_actual + c;
          // The same thread owns this element for every model.
          if (M == 1) *px = v * inv_m;
          else if (m == 0) *px = v;
          else if (m == M - 1) *px = (*px + v) * inv_m;
          else *px += v;
        }
      });
      __syncthreads();
    }
  }
  if (threadIdx.x < kRows && row0 + (int)threadIdx.x < n) {
    float bias_sum = 0.f;
    for (int m = 0; m < M; ++m) bias_sum += blast[m];
    e_out[row0 + threadIdx.x] = (erow[threadIdx.x] + bias_sum) * inv_m;
  }
}

template <bool GRAD>
int launch(const float* x, const void* wbuf, const float* fbuf, float* e_out,
           float* dx_out, int n, int in_actual, int n_layers,
           const int* dims, int models, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || models < 1)
    return (int)cudaErrorInvalidValue;
  NetDims nd;
  nd.n_layers = n_layers;
  int maxh = 0, sumh = 0;
  for (int l = 0; l <= n_layers; ++l) {
    nd.d[l] = dims[l];
    if (l < n_layers && (dims[l] <= 0 || dims[l] % 16 != 0))
      return (int)cudaErrorInvalidValue;
    if (l >= 1 && l < n_layers) {
      maxh = dims[l] > maxh ? dims[l] : maxh;
      sumh += dims[l];
    }
  }
  if (dims[n_layers] != 1 || in_actual > dims[0]) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  size_t smem = (size_t)kRows * (dims[0] + kPad) * sizeof(bf16)
                + 2 * (size_t)kRows * (maxh + kPad) * sizeof(bf16)
                + kRows * sizeof(float);
  if (GRAD) smem += (size_t)kRows * sumh * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_net_kernel<GRAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kRows - 1) / kRows;
  fused_net_kernel<GRAD><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, reinterpret_cast<const bf16*>(wbuf), fbuf, e_out, dx_out, n,
      in_actual, nd, models);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_nn_fwd(const float* x, const void* wbuf, const float* fbuf,
                 float* e_out, float* dx_out, int n, int in_actual,
                 int n_layers, const int* dims, int models, void* stream) {
  return launch<false>(x, wbuf, fbuf, e_out, dx_out, n, in_actual, n_layers,
                       dims, models, stream);
}

int fused_nn_fwdgrad(const float* x, const void* wbuf, const float* fbuf,
                     float* e_out, float* dx_out, int n, int in_actual,
                     int n_layers, const int* dims, int models, void* stream) {
  return launch<true>(x, wbuf, fbuf, e_out, dx_out, n, in_actual, n_layers,
                      dims, models, stream);
}

}  // extern "C"
