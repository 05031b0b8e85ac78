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
// 2.6k box, ~2.5 us at 3.35 TB/s); the arithmetic is a ballot and two
// popcounts per 32 lanes.
//
// Design: the Pallas kernel ranks lanes with a bf16 lower-triangular
// matmul and extracts keys with cap masked row sums, because the TPU has
// no cheap scan. Here one warp compacts one (row, block): each 32-lane
// chunk is read coalesced, __ballot_sync marks the valid lanes, a lane's
// rank is the running offset plus the popcount of the valid lanes below
// it, and the valid lanes whose rank is under the cap store their key.
// The order is the lane order, as in the Pallas kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlocks = 8;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

struct PackParams {
  int n_rows, width, k_total, npres;
  int woff[kMaxBlocks + 1];   // lane offsets of the species blocks
  int koff[kMaxBlocks + 1];   // packed-column offsets
  int caps[kMaxBlocks];
};

__global__ void __launch_bounds__(kThreads)
left_pack_kernel(const int* __restrict__ keys, int* __restrict__ packed,
                 int* __restrict__ counts, const PackParams p) {
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= p.n_rows * p.npres) return;        // whole warp leaves
  const int row = task / p.npres, s = task - row * p.npres;
  const int* krow = keys + (size_t)row * p.width;
  int* orow = packed + (size_t)row * p.k_total + p.koff[s];
  const int cap = p.caps[s];
  const int lo = p.woff[s], hi = p.woff[s + 1];
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  for (int base = lo; base < hi; base += 32) {
    const int l = base + lane;
    const int key = l < hi ? krow[l] : -1;
    const bool valid = key >= 0;
    const unsigned m = __ballot_sync(kFull, valid);
    const int rank = total + __popc(m & below);
    if (valid && rank < cap) orow[rank] = key;
    total += __popc(m);
  }
  for (int j = total + lane; j < cap; j += 32) orow[j] = -1;
  if (lane == 0) counts[(size_t)row * p.npres + s] = total;
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
  const long long tasks = (long long)n_rows * npres;
  const int blocks = (int)((tasks + kWarps - 1) / kWarps);
  left_pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, packed, counts, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
