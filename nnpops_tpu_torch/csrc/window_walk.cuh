// The walk of one cell's 27-cell window that the window radial kernel
// (window_radial.cu, B.2) and the PME direct-window kernel (pme_window.cu,
// B.5) share; the z-pair radial kernel (pair_radial.cu, B.9) walks its
// z-triple columns with it, and the cluster-pair kernel (cluster_radial.cu,
// B.8) uses its helpers. No entry point of its own.
//
// A block owns one cell. It stages the cell's window of kk lanes in shared
// memory. The lanes come in runs: a run is one (species block, stencil
// entry) of the wrapper's run table, a contiguous range of window lanes.
// Per run the block records its length up to its last occupied lane (a slot
// is empty when its x is >= EMPTY_ROW, FAR/2) and the bounding box of its
// occupied positions. The selection fills a cell's slots by rank, so a
// run's occupied lanes are a prefix of it and the cut run holds no empty
// lane; where an input has holes, an empty lane inside a run stays and
// fails the cutoff test (its coordinates are FAR).
//
// A unit of work is (real center row, group of runs); the block lists its
// real rows (x < EMPTY_ROW) once, and only those make units. For the
// unit's center a warp tests each run's box against the cutoff
// (`live_runs`): a run whose box lies at or beyond rc^2 holds no lane that
// can pair, and is skipped. The lanes of the live runs are then walked 64
// at a time, two independent 32-lane chunks (`walk`); the lanes whose pair
// passes the kernel's test go into the warp's queue, and every 32 queued
// pairs (then the rest) are handed to the kernel's batch body, one pair a
// thread. The queue never spans two units, so within a batch every lane
// is distinct.
//
// The box test is exact: with the box's gap to the center computed as the
// plain version computes a distance (each difference, square and sum
// rounded as PyTorch rounds it), the gap is never larger than the
// distance of any lane inside the box, so a skipped run holds no pair
// that the plain version would count.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEmpty = 0.5e6f;        // FAR / 2: EMPTY_ROW
constexpr int kEntries = 27;            // stencil entries of a window
constexpr int kMaxRuns = 8 * kEntries;  // 8 species blocks x 27 entries
constexpr int kMaxThreads = 1024;       // 32 warps
constexpr int kSmemLimit = 232448;      // bytes a block can use

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// An int that orders as the float does (an involution), so that a warp
// takes a float min or max with one __reduce_*_sync.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

// d2 = dx*dx + dy*dy + dz*dz rounded op by op as PyTorch rounds it.
__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// dx = v - c, ... and d2 = dx*dx + dy*dy + dz*dz, rounded op by op as
// PyTorch rounds them.
__device__ __forceinline__ float dist2_to(float4 v, float4 c, float& dx,
                                          float& dy, float& dz) {
  dx = __fsub_rn(v.x, c.x);
  dy = __fsub_rn(v.y, c.y);
  dz = __fsub_rn(v.z, c.z);
  return dist2_rn(dx, dy, dz);
}

// r = sqrt(max(d2, 1e-12)) and 1/r from one rsqrt.approx; above r_near
// (within 1e-6 of the cutoff), r as PyTorch's sqrt rounds it, so that
// min(r, rc) takes the plain version's branch.
__device__ __forceinline__ void radius(float d2, float r_near, float& r,
                                       float& rinv) {
  const float m = fmaxf(d2, 1e-12f);
  rinv = rsqrt_approx(m);
  r = m * rinv;
  if (r > r_near) r = __fsqrt_rn(m);
}

// The run table (host arrays copied into the kernel's parameters).
struct RunTable {
  int nruns;
  int first[kMaxRuns];   // first window lane of each run
  int len[kMaxRuns];     // lanes of each run
};

// The staged window in shared memory.
struct Stage {
  float4* lane;    // [kk] window lanes: x, y, z, payload
  int* tag;        // [kk] the kernel's integer tag of each lane (or null)
  int* start;      // [nruns] first lane of each run
  int* len;        // [nruns] lanes of each run up to its last occupied one
  float* box;      // [nruns * 6] lo x, y, z, hi x, y, z
};

// A region of `bytes` at 16-byte aligned offset `at`; returns its offset and
// moves `at` past it. Host and device lay shared memory out with the same
// calls, and every pointer is the __shared__ array plus an offset (so that
// the compiler keeps shared-memory loads and stores).
__host__ __device__ inline size_t region(size_t& at, size_t bytes) {
  const size_t off = at;
  at = (at + bytes + 15) / 16 * 16;
  return off;
}

struct StageLayout {
  size_t lane, tag, start, len, box;
};

__host__ __device__ inline StageLayout stage_layout(size_t& at, int kk,
                                                   int nruns, bool tag) {
  StageLayout o;
  o.lane = region(at, 16 * (size_t)kk);
  o.tag = tag ? region(at, 4 * (size_t)kk) : 0;
  o.start = region(at, 4 * (size_t)nruns);
  o.len = region(at, 4 * (size_t)nruns);
  o.box = region(at, 24 * (size_t)nruns);
  return o;
}

__device__ __forceinline__ Stage make_stage(unsigned char* smem,
                                            const StageLayout& o, bool tag) {
  Stage s;
  s.lane = reinterpret_cast<float4*>(smem + o.lane);
  s.tag = tag ? reinterpret_cast<int*>(smem + o.tag) : nullptr;
  s.start = reinterpret_cast<int*>(smem + o.start);
  s.len = reinterpret_cast<int*>(smem + o.len);
  s.box = reinterpret_cast<float*>(smem + o.box);
  return s;
}

// The warp's index, uniform as far as the compiler can tell.
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(kFull, (int)(threadIdx.x >> 5), 0);
}

// Stages the cell's window: all threads load every window lane l as (x, y,
// z, payload) = `load(l)` with its tag `tag(l)` (where s.tag is set) and run
// `extra()` (the kernel's own rows); then a warp per run records the run's
// first lane, cut length and box, and the last warp runs `rows()`. Ends
// with __syncthreads().
template <class Load, class Tag, class Extra, class Rows>
__device__ void stage_window(const RunTable& rt, const Stage& s, int kk,
                             Load load, Tag tag, Extra extra, Rows rows) {
  const int warp = warp_id(), lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int l = threadIdx.x; l < kk; l += blockDim.x) {
    s.lane[l] = load(l);
    if (s.tag) s.tag[l] = tag(l);
  }
  extra();
  __syncthreads();
  for (int r = warp; r < rt.nruns; r += nw) {
    const int first = rt.first[r], len = rt.len[r];
    int n = 0;
    int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN,
                                                        INT_MIN};
    for (int b = 0; b < len; b += 32) {
      const bool in = b + lane < len;
      const float4 v = in ? s.lane[first + b + lane]
                          : make_float4(kEmpty, kEmpty, kEmpty, 0.f);
      const bool occ = in && v.x < kEmpty;
      const unsigned bal = __ballot_sync(kFull, occ);
      if (bal) n = b + 32 - __clz(bal);
      const float c[3] = {v.x, v.y, v.z};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int k = order_key(c[a]);
        lo[a] = min(lo[a], __reduce_min_sync(kFull, occ ? k : INT_MAX));
        hi[a] = max(hi[a], __reduce_max_sync(kFull, occ ? k : INT_MIN));
      }
    }
    if (lane == 0) {
      s.start[r] = first;
      s.len[r] = n;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s.box[6 * r + a] = __int_as_float(order_key(__int_as_float(lo[a])));
        s.box[6 * r + 3 + a] =
            __int_as_float(order_key(__int_as_float(hi[a])));
      }
    }
  }
  if (warp == nw - 1) rows();
  __syncthreads();
}

// One warp lists the real rows (x < EMPTY_ROW) of `ctr` in order into
// `srow` and their number into *nreal.
__device__ inline void list_real_rows(const float4* ctr, int nrows, int* srow,
                                      int* nreal) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int b = 0; b < nrows; b += 32) {
    const int r = b + lane;
    const bool real = r < nrows && ctr[r].x < kEmpty;
    const unsigned bal = __ballot_sync(kFull, real);
    if (real) srow[n + __popc(bal & lanemask_lt())] = r;
    n += __popc(bal);
  }
  if (lane == 0) *nreal = n;
}

// The live runs of one unit for the center (px, py, pz): runs r0 + k *
// stride, k < nk <= 32. Lane k' < nlive holds the k'-th live run's first
// lane and its offset in the unit's walk; lanes past it hold offset
// `total`.
struct LiveRuns {
  int nlive, total, start, off;
};

__device__ __forceinline__ float box_gap(float p, float lo, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, p), __fsub_rn(p, hi)), 0.f);
}

// `tbl` is the warp's 64 ints of shared memory.
__device__ inline LiveRuns live_runs(const Stage& s, int r0, int stride,
                                     int nk, float px, float py, float pz,
                                     float rc2, int* tbl) {
  const int lane = threadIdx.x & 31;
  bool live = false;
  int st = 0, n = 0;
  if (lane < nk) {
    const int r = r0 + lane * stride;
    n = s.len[r];
    st = s.start[r];
    if (n > 0) {
      const float* b = s.box + 6 * r;
      live = dist2_rn(box_gap(px, b[0], b[3]), box_gap(py, b[1], b[4]),
                      box_gap(pz, b[2], b[5])) < rc2;
    }
  }
  const unsigned bal = __ballot_sync(kFull, live);
  if (live) {
    const int k = __popc(bal & lanemask_lt());
    tbl[k] = st;
    tbl[32 + k] = n;
  }
  __syncwarp();
  LiveRuns L;
  L.nlive = __popc(bal);
  st = lane < L.nlive ? tbl[lane] : 0;
  n = lane < L.nlive ? tbl[32 + lane] : 0;
  __syncwarp();
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  L.total = __shfl_sync(kFull, incl, 31);
  L.start = st;
  L.off = lane < L.nlive ? incl - n : L.total;
  return L;
}

// Window lane of walk position base + lane (meaningful where it is below
// total): the live run holding `base` is the last whose offset is at
// most base; each run that starts inside the chunk moves the lanes from
// its start on to the next run.
__device__ __forceinline__ int walk_pos(const LiveRuns& L, int base) {
  const int lane = threadIdx.x & 31;
  const int k0 = __popc(__ballot_sync(kFull, L.off <= base)) - 1;
  const int d = L.off - base;
  const unsigned starts =
      __reduce_or_sync(kFull, d > 0 && d < 32 ? 1u << d : 0u);
  const int k = max(k0, 0) + __popc(starts & ((2u << lane) - 1u));
  return __shfl_sync(kFull, L.start, k) + base + lane -
         __shfl_sync(kFull, L.off, k);
}

// Walks one unit: `test(pos)` decides whether window lane pos pairs with the
// unit's center; the accepted positions go through the warp's `queue`
// (96 ints of shared memory) to `batch(pos, on)`, called by the whole warp
// with one pair a thread (on = false for a thread without one). Positions
// go in walk order, so the order of every sum is fixed.
template <class Test, class Batch>
__device__ inline void walk(const LiveRuns& L, int* queue, Test test,
                            Batch batch) {
  const int lane = threadIdx.x & 31;
  int qn = 0;
  for (int base = 0; base < L.total; base += 64) {
    const int p0 = walk_pos(L, base), p1 = walk_pos(L, base + 32);
    const bool ok0 = base + lane < L.total && test(p0);
    const bool ok1 = base + 32 + lane < L.total && test(p1);
    const unsigned b0 = __ballot_sync(kFull, ok0);
    const unsigned b1 = __ballot_sync(kFull, ok1);
    const unsigned lt = lanemask_lt();
    if (ok0) queue[qn + __popc(b0 & lt)] = p0;
    qn += __popc(b0);
    if (ok1) queue[qn + __popc(b1 & lt)] = p1;
    qn += __popc(b1);
    while (qn >= 32) {
      __syncwarp();
      batch(queue[lane], true);
      __syncwarp();
      const int rem = qn - 32;
      const int v0 = lane < rem ? queue[32 + lane] : 0;
      const int v1 = lane + 32 < rem ? queue[64 + lane] : 0;
      __syncwarp();
      if (lane < rem) queue[lane] = v0;
      if (lane + 32 < rem) queue[32 + lane] = v1;
      __syncwarp();
      qn = rem;
    }
  }
  if (qn > 0) {
    __syncwarp();
    const bool on = lane < qn;
    batch(on ? queue[lane] : 0, on);
  }
  __syncwarp();
}

// Whether staged lane pos pairs with the center c (its own lane's index in
// the bits of c.w): inside the cutoff and not its own lane.
__device__ __forceinline__ bool pairs_with(const Stage& s, int pos, float4 c,
                                           float rc2) {
  float dx, dy, dz;
  return dist2_to(s.lane[pos], c, dx, dy, dz) < rc2 &&
         pos != __float_as_int(c.w);
}

// Sum over the warp in a fixed order (butterfly).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

// Streaming multiprocessors of the current device.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// Warps a block: 32 while the cells leave SMs without a block (one block a
// cell), else 16, so that two blocks share an SM.
inline int block_warps(int ncells) { return ncells < sm_count() ? 32 : 16; }

}  // namespace walk
