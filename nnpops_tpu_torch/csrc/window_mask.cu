// Window validity mask and lane-index left-pack, for sm_90a.
//
// Replaces two Pallas TPU kernels of the window selection's 'mask'
// compaction (nnpops_tpu/neighbors/window.py _compact_window_mask):
// * nnpops_tpu/ops/pallas_select.py:180 make_window_mask (pallas_call at
//   :244): per cell, mask[cell, r, l] = d2 < w2 between center row r and
//   window lane l, the static self lane 27 off_s + 13 cs + (r - off_s) of a
//   species-s row excluded. The Pallas kernel emits bf16 0/1 (Mosaic
//   rejects narrow vector compares); this one writes bytes (torch.bool).
// * nnpops_tpu/ops/pallas_select.py:260 make_left_pack_lanes (pallas_call
//   at :334): per row and species block s, the block-local lane index of
//   the first caps[s] valid lanes in lane order, -1 beyond the block's
//   count, and the block's true count. The Pallas kernel ranks with a bf16
//   triangular matmul on 128-lane-padded f32 blocks; this one ranks with
//   popcounts and a warp scan, on int32 output and unpadded widths.
// Wrappers and plain PyTorch versions: nnpops_tpu_torch/ops/cuda_select.py.
//
// What bounds them on the H100: the mask kernel reads the cell's 3 x kk
// window and c centers and writes c x kk bytes; its ten or so
// instructions a byte take about as long to issue as the bytes take to
// store, so the design keeps every other instruction out of the per-byte
// loop and lets the two overlap across blocks. The left-pack reads the
// N x W mask bytes once and writes N x (sum caps + npres) int32; its
// bytes are few, and its time goes to the instructions of each (row,
// species block): the scan and the lane writes. Its row strides are odd,
// so no row starts aligned.
//
// Mask design: a block per cell, 128 threads. A thread holds L window
// lanes (t + 128 i, so a warp's lanes are consecutive) in registers, read
// once from device memory, and walks the cell's rows; a row's center and
// self lane come from one broadcast shared load, so a byte costs its
// distance, its compare and one shared byte store, with no division or
// species search. The distance is rounded as the selection's PyTorch ops
// round it (subtract, square, then two adds, no fused multiply-add), so
// the mask selects exactly the pairs of the default 'kernel' compaction.
// Empty (FAR) rows are computed like any other. The bytes go to a shared
// stage placed at the cell's output address mod 16, so that every
// 16-byte-aligned chunk of the cell's output is a 16-byte-aligned chunk
// of the stage: after the self lanes are zeroed, the block writes the
// aligned interior with 16-byte stores and the head and tail (at most 15
// bytes each) with byte stores. Staging was chosen over walking the
// output in 16-byte chunks: a chunk crosses rows at an odd stride, so its
// lanes change from row to row and the window could not stay in
// registers.
//
// Left-pack design: persistent blocks of 8 warps walk tiles of
// consecutive mask rows (one contiguous byte range, about 10 KB). Each
// tile's 16-byte-aligned enclosing range is copied into shared memory with
// cp.async, double-buffered: the next tile is in flight while the warps
// compact the current one. A warp takes a (row, species block): each
// thread reads one aligned 16-byte chunk of the block (512 lanes a warp
// pass), masks the bytes outside the block's unaligned head and tail,
// counts its valid lanes with a popcount, and a warp exclusive scan gives
// its rank; the thread then writes its valid lanes' indices in lane order
// at rank < cap. No atomics, so two launches are bitwise equal.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSpecies = 8;
constexpr unsigned kFull = 0xffffffffu;

// The warp index, made warp-uniform for the compiler (a shuffle result),
// so that warp-collective loops need no WARPSYNC.
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(kFull, (int)(threadIdx.x >> 5), 0);
}

// ---------------------------------------------------------------------------
// The mask (B.7a).
// ---------------------------------------------------------------------------

constexpr int kMaskThreads = 128;
constexpr int kMaskMaxLanes = 8;            // window lanes a thread holds
constexpr int kStageBytes = 32 * 1024;      // rows of output staged at once

struct MaskParams {
  int c, kk, npres, rows_per_pass;
  float w2;
  int row_off[kMaxSpecies + 1];
  int self_shift[kMaxSpecies];    // self lane = row + self_shift[species]
};

// Shared memory, as offsets from the dynamic __shared__ array: [0, 16 c)
// a float4 per center row {x, y, z, self lane as int bits}; from 16 c the
// stage, a pass's rows of bytes from offset (output address mod 16).
template <int L>
__global__ void __launch_bounds__(kMaskThreads)
window_mask_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                   const float* __restrict__ cz,
                   const float* __restrict__ centers,
                   uint8_t* __restrict__ mask, const MaskParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int c = p.c, kk = p.kk;
  const size_t cell = blockIdx.x;
  for (int r = t; r < c; r += kMaskThreads) {
    int s = 0;
    for (int k = 1; k < p.npres; ++k)
      if (r >= p.row_off[k]) s = k;
    const float* ce = centers + (cell * c + r) * 3;
    reinterpret_cast<float4*>(smem)[r] = make_float4(
        ce[0], ce[1], ce[2], __int_as_float(r + p.self_shift[s]));
  }
  const float* wx = cx + cell * kk;
  const float* wy = cy + cell * kk;
  const float* wz = cz + cell * kk;
  const int stage = 16 * c;
  for (int r0 = 0; r0 < c; r0 += p.rows_per_pass) {
    const int r1 = min(r0 + p.rows_per_pass, c);
    uint8_t* out = mask + (cell * c + r0) * kk;
    const int head = (int)(reinterpret_cast<uintptr_t>(out) & 15);
    __syncthreads();        // centers staged; the last pass written out
    for (int l0 = 0; l0 < kk; l0 += L * kMaskThreads) {
      float x[L], y[L], z[L];
      bool on[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int l = l0 + t + i * kMaskThreads;
        on[i] = l < kk;
        x[i] = on[i] ? wx[l] : 0.f;
        y[i] = on[i] ? wy[l] : 0.f;
        z[i] = on[i] ? wz[l] : 0.f;
      }
      int row = stage + head + l0 + t;
      for (int r = r0; r < r1; ++r, row += kk) {
        const float4 ce = reinterpret_cast<const float4*>(smem)[r];
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const float dx = __fsub_rn(x[i], ce.x);
          const float dy = __fsub_rn(y[i], ce.y);
          const float dz = __fsub_rn(z[i], ce.z);
          const float d2 = __fadd_rn(
              __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
              __fmul_rn(dz, dz));
          if (on[i]) smem[row + i * kMaskThreads] = d2 < p.w2;
        }
      }
    }
    __syncthreads();
    for (int r = r0 + t; r < r1; r += kMaskThreads)
      smem[stage + head + (r - r0) * kk +
           __float_as_int(reinterpret_cast<const float4*>(smem)[r].w)] = 0;
    __syncthreads();
    // out[j] is stage byte head + j; from lead on both are 16-aligned.
    const int n = (r1 - r0) * kk;
    const int lead = min((16 - head) & 15, n);
    const int body = (n - lead) >> 4;
    const int tail = lead + 16 * body;
    if (t < lead) out[t] = smem[stage + head + t];
    if (t >= 16 && t - 16 < n - tail)
      out[tail + t - 16] = smem[stage + head + tail + t - 16];
    uint4* dst = reinterpret_cast<uint4*>(out + lead);
    const int src = stage + head + lead;
    for (int q = t; q < body; q += kMaskThreads)
      dst[q] = *reinterpret_cast<const uint4*>(smem + src + 16 * q);
  }
}

template <int L>
cudaError_t launch_mask(const float* cx, const float* cy, const float* cz,
                        const float* centers, uint8_t* mask, int ncells,
                        const MaskParams& p, size_t smem,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_mask_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  window_mask_kernel<L><<<ncells, kMaskThreads, smem, stream>>>(
      cx, cy, cz, centers, mask, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The lane left-pack (B.7b).
// ---------------------------------------------------------------------------

constexpr int kPackWarps = 8;
constexpr int kPackThreads = kPackWarps * 32;
constexpr int kTileBytes = 10 * 1024;       // mask bytes a tile aims at

struct LanesParams {
  int n_rows, width, k_total, npres;
  int rows_per_tile, ntiles, buf_bytes;
  int woff[kMaxSpecies + 1];    // lane offsets of the species blocks
  int koff[kMaxSpecies + 1];    // packed-column offsets
  int caps[kMaxSpecies];
};

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Bit i set where byte i of w is nonzero: each byte's top bit is set by
// ((b & 0x7f) + 0x7f) | b, and the product moves the four top bits to
// bits 28-31 without carries.
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  const unsigned top = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return (top * 0x00204081u) >> 28;
}

// Copy tile `tile`'s 16-byte-aligned enclosing range to shared address
// `dst` (the aligned chunks around a row's bytes lie in mapped memory).
__device__ __forceinline__ void load_tile(const uint8_t* mask,
                                          const LanesParams& p, int tile,
                                          unsigned dst) {
  const size_t r0 = (size_t)tile * p.rows_per_tile;
  const size_t r1 = min(r0 + p.rows_per_tile, (size_t)p.n_rows);
  const uintptr_t m = reinterpret_cast<uintptr_t>(mask);
  const uintptr_t g0 = (m + r0 * p.width) & ~(uintptr_t)15;
  const uintptr_t g1 = (m + r1 * p.width + 15) & ~(uintptr_t)15;
  const int chunks = (int)((g1 - g0) >> 4);
  for (int q = threadIdx.x; q < chunks; q += kPackThreads)
    cp_async16(dst + 16 * q, reinterpret_cast<const void*>(g0 + 16 * q));
}

// One warp packs one species block: its lanes are the bytes [a, a + width)
// of the 16-byte-aligned tile buffer `tile`; `out` its cap packed columns,
// `count` its count.
__device__ __forceinline__ void pack_block(const unsigned char* tile, int a,
                                           int width, int cap,
                                           int* __restrict__ out,
                                           int* __restrict__ count,
                                           int lane) {
  const int b = a + width;
  const int q0 = a >> 4;
  const int nq = width > 0 ? ((b + 15) >> 4) - q0 : 0;
  int total = 0;
  for (int pass = 0; pass < nq; pass += 32) {
    const int q = q0 + pass + lane;
    unsigned bits = 0;
    if (pass + lane < nq) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + 16 * q);
      bits = nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 |
             nonzero4(v.w) << 12;
      const int lo = a - 16 * q, hi = b - 16 * q;   // lo < 16, hi > 0
      if (lo > 0) bits &= ~0u << lo;
      if (hi < 16) bits &= (1u << hi) - 1u;
    }
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    int rank = total + incl - cnt;
    const int l = 16 * q - a;           // block-local lane of bit 0
    while (bits != 0 && rank < cap) {
      out[rank++] = l + __ffs(bits) - 1;
      bits &= bits - 1u;
    }
    total += __shfl_sync(kFull, incl, 31);
  }
  for (int j = min(total, cap) + lane; j < cap; j += 32) out[j] = -1;
  if (lane == 0) *count = total;
}

// Shared memory: two tile buffers of buf_bytes each.
__global__ void __launch_bounds__(kPackThreads)
left_pack_lanes_kernel(const uint8_t* __restrict__ mask,
                       int* __restrict__ lanes, int* __restrict__ counts,
                       const LanesParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smem);
  const int warp = warp_id(), lane = threadIdx.x & 31;
  int tile = blockIdx.x;
  if (tile < p.ntiles) load_tile(mask, p, tile, sbase);
  cp_async_commit();
  for (int it = 0; tile < p.ntiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.ntiles)
      load_tile(mask, p, next, sbase + ((it + 1) & 1) * p.buf_bytes);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();                  // this tile is in shared memory
    const size_t r0 = (size_t)tile * p.rows_per_tile;
    const int nr = min(p.rows_per_tile, p.n_rows - (int)r0);
    // Shared offsets in a buffer are the global addresses mod 16.
    const int head = (int)((reinterpret_cast<uintptr_t>(mask) +
                            r0 * p.width) & 15);
    const unsigned char* buf = smem + (it & 1) * p.buf_bytes;
    for (int rl = warp; rl < nr; rl += kPackWarps) {
      const size_t row = r0 + rl;
      for (int s = 0; s < p.npres; ++s)
        pack_block(buf, head + rl * p.width + p.woff[s],
                   p.woff[s + 1] - p.woff[s], p.caps[s],
                   lanes + row * p.k_total + p.koff[s],
                   counts + row * p.npres + s, lane);
    }
    __syncthreads();                  // done reading before it is refilled
  }
}

int g_sm_count = 0;

}  // namespace

extern "C" {

int window_mask(const float* cx, const float* cy, const float* cz,
                const float* centers, uint8_t* mask, int ncells, int npres,
                const int* cell_caps, double w2, void* stream) {
  if (ncells <= 0) return 0;
  if (npres < 1 || npres > kMaxSpecies) return (int)cudaErrorInvalidValue;
  MaskParams p;
  p.npres = npres;
  p.w2 = (float)w2;
  p.row_off[0] = 0;
  for (int s = 0; s < kMaxSpecies; ++s) {
    const int cs = s < npres ? cell_caps[s] : 0;
    if (cs < 0) return (int)cudaErrorInvalidValue;
    // 27 off_s + 13 cs - off_s: the self lane of row r is r + this.
    p.self_shift[s] = 26 * p.row_off[s] + 13 * cs;
    p.row_off[s + 1] = p.row_off[s] + cs;
  }
  p.c = p.row_off[npres];
  p.kk = 27 * p.c;
  if (p.c == 0) return 0;
  p.rows_per_pass = p.kk >= kStageBytes ? 1 : min(p.c, kStageBytes / p.kk);
  const size_t smem = 16 * (size_t)p.c + 16 + (size_t)p.rows_per_pass * p.kk;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int lanes = (p.kk + kMaskThreads - 1) / kMaskThreads;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (lanes < kMaskMaxLanes ? lanes : kMaskMaxLanes) {
    case 1: err = launch_mask<1>(cx, cy, cz, centers, mask, ncells, p, smem, st); break;
    case 2: err = launch_mask<2>(cx, cy, cz, centers, mask, ncells, p, smem, st); break;
    case 3: err = launch_mask<3>(cx, cy, cz, centers, mask, ncells, p, smem, st); break;
    case 4: err = launch_mask<4>(cx, cy, cz, centers, mask, ncells, p, smem, st); break;
    case 5: err = launch_mask<5>(cx, cy, cz, centers, mask, ncells, p, smem, st); break;
    case 6: err = launch_mask<6>(cx, cy, cz, centers, mask, ncells, p, smem, st); break;
    case 7: err = launch_mask<7>(cx, cy, cz, centers, mask, ncells, p, smem, st); break;
    default: err = launch_mask<8>(cx, cy, cz, centers, mask, ncells, p, smem, st); break;
  }
  return (int)err;
}

int left_pack_lanes(const uint8_t* mask, int* lanes, int* counts,
                    int n_rows, int width, int k_total, int npres,
                    const int* widths, const int* caps, void* stream) {
  if (n_rows <= 0) return 0;
  if (npres < 1 || npres > kMaxSpecies) return (int)cudaErrorInvalidValue;
  LanesParams p;
  p.n_rows = n_rows;
  p.width = width;
  p.k_total = k_total;
  p.npres = npres;
  p.woff[0] = 0;
  p.koff[0] = 0;
  for (int s = 0; s < kMaxSpecies; ++s) {
    const bool on = s < npres;
    p.caps[s] = on ? caps[s] : 0;
    p.woff[s + 1] = p.woff[s] + (on ? widths[s] : 0);
    p.koff[s + 1] = p.koff[s] + (on ? caps[s] : 0);
  }
  if (p.woff[npres] != width || p.koff[npres] != k_total)
    return (int)cudaErrorInvalidValue;
  // Whole warps' worth of rows a tile where a row is short.
  int rows = width >= kTileBytes ? 1 : kTileBytes / width;
  if (rows >= kPackWarps) rows -= rows % kPackWarps;
  p.rows_per_tile = rows;
  p.ntiles = (n_rows + rows - 1) / rows;
  p.buf_bytes = (int)(((size_t)rows * width + 30 + 15) & ~(size_t)15);
  const size_t smem = 2 * (size_t)p.buf_bytes;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(left_pack_lanes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (g_sm_count == 0) {
    int dev;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&g_sm_count,
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, left_pack_lanes_kernel, kPackThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int resident = g_sm_count * (per_sm > 0 ? per_sm : 1);
  const int blocks = p.ntiles < resident ? p.ntiles : resident;
  left_pack_lanes_kernel<<<blocks, kPackThreads, smem,
                           (cudaStream_t)stream>>>(mask, lanes, counts, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
