// Left-pack of valid candidate keys per (row, species block), for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_select.py:55
// make_left_pack (pallas_call at :139), which runs once per selection of
// the window path. Wrapper and plain PyTorch version:
// nnpops_tpu_torch/ops/cuda_select.py.
//
// Semantics: keys [n_rows, width] int32, valid <=> key >= 0; species block
// s owns lanes [woff[s], woff[s+1]). Per row and block, the first caps[s]
// valid keys in ascending lane order go to packed[row, koff[s] + rank],
// -1 fills the block beyond its count, and counts[row, s] is the block's
// true number of valid keys (it may exceed the cap).
//
// What bounds it on the H100: memory. It reads every key once and writes
// the packed lists and counts once (2,601 x 783 int32 = 8.1 MB in at the
// 2.6k box, 2.6 us at 3.35 TB/s; 26,010 x 621 = 64.6 MB at 26k, 19 us);
// the arithmetic is a ballot and two popcounts per 32 lanes. A warp that
// reads one 32-lane chunk, ballots it and only then reads the next keeps
// 128 bytes in flight and is bound by the latency of that chain of loads;
// with every chunk's load in flight, what is left is the instructions a
// chunk costs (14, about half of them to store a valid key) and, at 2.6k,
// the launch and one round of loads.
//
// Design: the Pallas kernel ranks lanes with a bf16 lower-triangular
// matmul and extracts keys with cap masked row sums, because the TPU has
// no cheap scan. Here a warp takes a (row, species block): the grid's x
// is a group of 8 rows, its y the block, so no division finds them. The
// warp reads its block as 32-lane chunks, one key a lane a chunk, up to
// kChunks (16: the widest block at the 2.6k and 26k shapes is 486 lanes)
// at once, every load issued before the first ballot, and keeps the keys
// in registers; a wider block runs in groups of kChunks chunks, each
// group's loads in flight together. Then chunk by chunk from registers: a
// ballot marks the valid lanes, and a valid lane stores its key at the
// list's next free slot plus the popcount of the valid lanes below it,
// while the cap leaves room. The slot pointer and the room left move by
// the chunk's popcount, so no rank or address is recomputed from the
// row. -1 fills the block beyond its count and lane 0 stores the count.
// The order is the lane order, as in the Pallas kernel, and the work is
// integer and in a fixed order: two launches are bitwise equal.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlocks = 8;
constexpr int kWarps = 8;                  // rows a thread block
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = 16;                // 32-lane chunks a warp holds
constexpr unsigned kFull = 0xffffffffu;

struct PackParams {
  int n_rows, width, k_total, npres;
  int woff[kMaxBlocks + 1];   // lane offsets of the species blocks
  int koff[kMaxBlocks + 1];   // packed-column offsets
  int caps[kMaxBlocks];
};

// The warp index, made warp-uniform for the compiler (a shuffle result),
// so that the warp-collective loops need no WARPSYNC.
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(kFull, (int)(threadIdx.x >> 5), 0);
}

__global__ void __launch_bounds__(kThreads)
left_pack_kernel(const int* __restrict__ keys, int* __restrict__ packed,
                 int* __restrict__ counts, const PackParams p) {
  const int row = blockIdx.x * kWarps + warp_id();
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (row >= p.n_rows) return;                   // whole warp leaves
  const int lo = p.woff[s], w = p.woff[s + 1] - lo;
  const unsigned below = (1u << lane) - 1u;
  const int* src = keys + (size_t)row * p.width + lo + lane;
  // `out` walks the list (the next valid key's slot); `room` is the cap
  // less the valid keys so far, below 0 once the cap is passed.
  int* out = packed + (size_t)row * p.k_total + p.koff[s];
  int room = p.caps[s];
  for (int g = 0; g < w; g += 32 * kChunks) {
    const int lim = w - g - lane;        // chunk j is in the block: 32 j < lim
    int k[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      k[j] = 32 * j < lim ? src[g + 32 * j] : -1;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (32 * j >= w - g) break;
      const bool valid = k[j] >= 0;
      const unsigned m = __ballot_sync(kFull, valid);
      const int before = __popc(m & below);
      if (valid && before < room) out[before] = k[j];
      const int n = __popc(m);
      out += n;
      room -= n;
    }
  }
  for (int j = lane; j < room; j += 32) out[j] = -1;
  if (lane == 0) counts[(size_t)row * p.npres + s] = p.caps[s] - room;
}

}  // namespace

extern "C" {

int left_pack(const int* keys, int* packed, int* counts, int n_rows,
              int width, int k_total, int npres, const int* widths,
              const int* caps, void* stream) {
  if (n_rows <= 0) return 0;
  if (npres < 1 || npres > kMaxBlocks) return (int)cudaErrorInvalidValue;
  PackParams p;
  p.n_rows = n_rows;
  p.width = width;
  p.k_total = k_total;
  p.npres = npres;
  p.woff[0] = 0;
  p.koff[0] = 0;
  for (int s = 0; s < kMaxBlocks; ++s) {
    const bool on = s < npres;
    p.caps[s] = on ? caps[s] : 0;
    p.woff[s + 1] = p.woff[s] + (on ? widths[s] : 0);
    p.koff[s + 1] = p.koff[s] + (on ? caps[s] : 0);
  }
  if (p.woff[npres] != width || p.koff[npres] != k_total)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + kWarps - 1) / kWarps, npres);
  left_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      keys, packed, counts, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
