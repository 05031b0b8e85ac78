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
//   triangular matmul on 128-lane-padded f32 blocks; this one is
//   csrc/left_pack.cu's warp compaction with the key replaced by the lane
//   index, on int32 output and unpadded widths.
// Wrappers and plain PyTorch versions: nnpops_tpu_torch/ops/cuda_select.py.
//
// What bounds them on the H100: memory. The mask kernel reads the cell's
// 3 x kk window and c centers and writes c x kk bytes (about 7 arithmetic
// operations a byte written); the left-pack reads the N x W mask bytes
// once and writes N x (sum caps + npres) int32.
//
// Design: the mask is one block per cell, the window staged in shared
// memory, a thread per (row, lane) byte. Its distance is rounded as the
// selection's PyTorch ops round it (subtract, square, then two adds, no
// fused multiply-add), so the mask selects exactly the pairs the default
// 'kernel' compaction selects. The left-pack is a warp per (row, block):
// each 32-lane chunk of bytes is read coalesced, __ballot_sync marks the
// valid lanes and a lane's rank is the running count plus a popcount.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSpecies = 8;
constexpr unsigned kFull = 0xffffffffu;

struct MaskParams {
  int ncells, c, kk, npres;
  float w2;
  int row_off[kMaxSpecies + 1];
  int self_shift[kMaxSpecies];    // self lane = row + self_shift[species]
};

__global__ void __launch_bounds__(kThreads)
window_mask_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                   const float* __restrict__ cz,
                   const float* __restrict__ centers,
                   uint8_t* __restrict__ mask, const MaskParams p) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + p.kk;
  float* sz = sy + p.kk;
  float* sc = sz + p.kk;                           // [c][3]
  const int cell = blockIdx.x;
  const size_t base = (size_t)cell * p.kk;
  for (int l = threadIdx.x; l < p.kk; l += kThreads) {
    sx[l] = cx[base + l];
    sy[l] = cy[base + l];
    sz[l] = cz[base + l];
  }
  for (int i = threadIdx.x; i < 3 * p.c; i += kThreads)
    sc[i] = centers[(size_t)cell * 3 * p.c + i];
  __syncthreads();
  uint8_t* out = mask + (size_t)cell * p.c * p.kk;
  for (int idx = threadIdx.x; idx < p.c * p.kk; idx += kThreads) {
    const int r = idx / p.kk, l = idx - r * p.kk;
    int s = 0;
    for (int k = 1; k < p.npres; ++k)
      if (r >= p.row_off[k]) s = k;
    const float dx = __fsub_rn(sx[l], sc[3 * r]);
    const float dy = __fsub_rn(sy[l], sc[3 * r + 1]);
    const float dz = __fsub_rn(sz[l], sc[3 * r + 2]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    out[idx] = (d2 < p.w2 && l != r + p.self_shift[s]) ? 1 : 0;
  }
}

struct LanesParams {
  int n_rows, width, k_total, npres;
  int woff[kMaxSpecies + 1];    // lane offsets of the species blocks
  int koff[kMaxSpecies + 1];    // packed-column offsets
  int caps[kMaxSpecies];
};

__global__ void __launch_bounds__(kThreads)
left_pack_lanes_kernel(const uint8_t* __restrict__ mask,
                       int* __restrict__ lanes, int* __restrict__ counts,
                       const LanesParams p) {
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= p.n_rows * p.npres) return;        // whole warp leaves
  const int row = task / p.npres, s = task - row * p.npres;
  const uint8_t* mrow = mask + (size_t)row * p.width;
  int* orow = lanes + (size_t)row * p.k_total + p.koff[s];
  const int cap = p.caps[s];
  const int lo = p.woff[s], hi = p.woff[s + 1];
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  for (int base = lo; base < hi; base += 32) {
    const int l = base + lane;
    const bool valid = l < hi && mrow[l] != 0;
    const unsigned m = __ballot_sync(kFull, valid);
    const int rank = total + __popc(m & below);
    if (valid && rank < cap) orow[rank] = l - lo;
    total += __popc(m);
  }
  for (int j = total + lane; j < cap; j += 32) orow[j] = -1;
  if (lane == 0) counts[(size_t)row * p.npres + s] = total;
}

}  // namespace

extern "C" {

int window_mask(const float* cx, const float* cy, const float* cz,
                const float* centers, uint8_t* mask, int ncells, int npres,
                const int* cell_caps, double w2, void* stream) {
  if (ncells <= 0) return 0;
  if (npres < 1 || npres > kMaxSpecies) return (int)cudaErrorInvalidValue;
  MaskParams p;
  p.ncells = ncells;
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
  const size_t smem = (3 * (size_t)p.kk + 3 * (size_t)p.c) * sizeof(float);
  if (smem > 48 * 1024) {
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        window_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  window_mask_kernel<<<ncells, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, cz, centers, mask, p);
  return (int)cudaGetLastError();
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
  const long long tasks = (long long)n_rows * npres;
  const int blocks = (int)((tasks + kWarps - 1) / kWarps);
  left_pack_lanes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      mask, lanes, counts, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
