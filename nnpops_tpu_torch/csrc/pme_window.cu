// PME direct space over the dense 27-cell window, forward and backward,
// for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_pme.py:64
// make_pme_window_kernel: fwd_kernel (:177, pallas_call at :288/:292) and
// bwd_kernel (:199). Wrapper, autograd Function, plain PyTorch version and
// host side: nnpops_tpu_torch/ops/cuda_pme.py (its docstring states the
// contract).
//
// Per cell a of the nx x ny x nz grid, every center row i (the cell's own
// slots, [ncells, c, 4] = x, y, z, q) is paired with the cell's window
// lanes l (four [ncells, kk] planes, kk = 27 c, stencil-entry-major, image
// shifts applied, empty slots at FAR with charge 0):
//   e_i = 1/2 ke q_i sum_l q_l erfc(alpha r_il) / r_il
// over the lanes with r_il^2 < rc^2 that are neither the center's own slot
// nor one of its E exclusion slot ids. A lane's global slot id is its
// stencil cell's id times c plus its rank, from the cell id and the lane
// index (lane_slot_ids at pallas_pme.py:135-152). erfc is the Abramowitz
// and Stegun 7.1.26 polynomial (|eps| <= 1.5e-7), as in the Pallas kernel
// and the plain version.
//
// What bounds it on the H100: the bytes of the four candidate planes
// (16 kk bytes a cell, 1.7 MB at 2,601 atoms) and, about as much, FP32
// operations (an FMA counts two; a sqrt, exp or division one): about 10 a
// tested (center, lane) pair for the distance and the slot tests, 22 more
// a pair inside the cutoff forward (sqrt, exp, the erfc polynomial, a
// division) and 38 more backward. Each pair is tested once per direction
// (the sum is over directed pairs, hence the 1/2); the backward below
// evaluates every pair twice, once per pass.
//
// Design: one block of 8 warps per cell, over all cells in one launch (the
// Pallas kernel's bucketing only trims padded center rows on the TPU's
// uniform grid). The block stages the cell's four planes and the lanes'
// slot ids in shared memory, and the cell's exclusion rows. Forward: a warp
// per center row walks the window 32 lanes at a time and reduces its sum
// with shuffles (fixed order). Backward, recomputing the geometry, in two
// passes over the same pairs: a warp per center row forms the center's
// cotangent (x, y, z, q); then a thread per window lane walks the cell's
// center rows (staged in shared memory) and sums the lane's cotangent in
// registers, written once. One block holds the whole cell, so no atomics
// are needed and every summation order is fixed. Center rows at or beyond
// FAR/2 are empty slots: they write 0 and test no lane; empty lanes get 0.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kEmpty = 0.5e6f;        // FAR / 2
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

struct PmeParams {
  int ncells, nx, ny, nz, c, kk, ne;
  float rc2, alpha, half_ke;
};

// erfc(x), x >= 0, from ex = exp(-x^2): A&S 7.1.26 (pallas_pme.py:55-61).
__device__ __forceinline__ float erfc_poly(float x, float ex) {
  const float t = 1.f / (1.f + 0.3275911f * x);
  float p = 1.061405429f;
  p = p * t + -1.453152027f;
  p = p * t + 1.421413741f;
  p = p * t + -0.284496736f;
  p = p * t + 0.254829592f;
  return p * t * ex;
}

struct Smem {
  float *x, *y, *z, *q;
  int *sid, *excl;
};

__device__ __forceinline__ Smem carve(void* raw, const PmeParams& p) {
  Smem s;
  s.x = reinterpret_cast<float*>(raw);
  s.y = s.x + p.kk;
  s.z = s.y + p.kk;
  s.q = s.z + p.kk;
  s.sid = reinterpret_cast<int*>(s.q + p.kk);
  s.excl = s.sid + p.kk;
  return s;
}

// The cell's window planes, every lane's global slot id, and the cell's
// exclusion rows.
__device__ __forceinline__ void stage(const float* __restrict__ cx,
                                      const float* __restrict__ cy,
                                      const float* __restrict__ cz,
                                      const float* __restrict__ cq,
                                      const int* __restrict__ excl, int cell,
                                      const PmeParams& p, const Smem& s) {
  const size_t base = (size_t)cell * p.kk;
  const int az = cell % p.nz, axy = cell / p.nz;
  const int ay = axy % p.ny, ax = axy / p.ny;
  for (int l = threadIdx.x; l < p.kk; l += kThreads) {
    s.x[l] = cx[base + l];
    s.y[l] = cy[base + l];
    s.z[l] = cz[base + l];
    s.q[l] = cq[base + l];
    const int entry = l / p.c, rank = l - entry * p.c;
    const int bx = (ax + entry / 9 - 1 + p.nx) % p.nx;
    const int by = (ay + (entry / 3) % 3 - 1 + p.ny) % p.ny;
    const int bz = (az + entry % 3 - 1 + p.nz) % p.nz;
    s.sid[l] = ((bx * p.ny + by) * p.nz + bz) * p.c + rank;
  }
  const size_t ebase = (size_t)cell * p.c * p.ne;
  for (int i = threadIdx.x; i < p.c * p.ne; i += kThreads)
    s.excl[i] = excl[ebase + i];
}

// Whether lane slot `sid` pairs with center row `row` of cell `cell`.
__device__ __forceinline__ bool pairs_with(int sid, int cell, int row,
                                           const PmeParams& p,
                                           const Smem& s) {
  if (sid == cell * p.c + row) return false;
  const int* ex = s.excl + row * p.ne;
  for (int e = 0; e < p.ne; ++e)
    if (ex[e] == sid) return false;
  return true;
}

__global__ void __launch_bounds__(kThreads)
pme_window_fwd_kernel(const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ cz,
                      const float* __restrict__ cq,
                      const float* __restrict__ centers,
                      const int* __restrict__ excl, float* __restrict__ out,
                      const PmeParams p) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, p);
  const int cell = blockIdx.x;
  stage(cx, cy, cz, cq, excl, cell, p, s);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < p.c; row += kWarps) {
    const size_t crow = (size_t)cell * p.c + row;
    const float px = centers[crow * 4], py = centers[crow * 4 + 1],
                pz = centers[crow * 4 + 2], pq = centers[crow * 4 + 3];
    float acc = 0.f;
    if (px < kEmpty) {
      for (int l = lane; l < p.kk; l += 32) {
        const float dx = s.x[l] - px, dy = s.y[l] - py, dz = s.z[l] - pz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < p.rc2 && pairs_with(s.sid[l], cell, row, p, s)) {
          const float r = sqrtf(fmaxf(d2, 1e-12f));
          const float x = p.alpha * r;
          acc += s.q[l] * (erfc_poly(x, expf(-x * x)) / r);
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
    }
    if (lane == 0) out[crow] = p.half_ke * pq * acc;
  }
}

__global__ void __launch_bounds__(kThreads)
pme_window_bwd_kernel(const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ cz,
                      const float* __restrict__ cq,
                      const float* __restrict__ centers,
                      const int* __restrict__ excl,
                      const float* __restrict__ g,
                      float* __restrict__ dcand,
                      float* __restrict__ dctr, const PmeParams p) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, p);
  float* sc = reinterpret_cast<float*>(s.excl + p.c * p.ne);  // [c, 4]
  float* sg = sc + 4 * p.c;                   // 1/2 ke g of every row
  const int cell = blockIdx.x;
  stage(cx, cy, cz, cq, excl, cell, p, s);
  for (int i = threadIdx.x; i < p.c; i += kThreads) {
    const size_t crow = (size_t)cell * p.c + i;
    for (int k = 0; k < 4; ++k) sc[4 * i + k] = centers[crow * 4 + k];
    sg[i] = p.half_ke * g[crow];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float two_al = kTwoOverSqrtPi * p.alpha;

  // Pass 1: a warp per center row, the center's cotangent.
  for (int row = warp; row < p.c; row += kWarps) {
    const float px = sc[4 * row], py = sc[4 * row + 1], pz = sc[4 * row + 2],
                pq = sc[4 * row + 3], gh = sg[row];
    float gx = 0.f, gy = 0.f, gz = 0.f, gq = 0.f;
    if (px < kEmpty) {
      for (int l = lane; l < p.kk; l += 32) {
        const float dx = s.x[l] - px, dy = s.y[l] - py, dz = s.z[l] - pz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < p.rc2 && pairs_with(s.sid[l], cell, row, p, s)) {
          const float r = sqrtf(fmaxf(d2, 1e-12f));
          const float rinv = 1.f / r;
          const float x = p.alpha * r;
          const float ex = expf(-x * x);
          const float erfc_r = erfc_poly(x, ex);
          const float w = erfc_r * rinv;
          // d/dr [erfc(al r)/r] = -(2 al/sqrt(pi) e^{-al^2 r^2} + erfc/r)/r
          const float dw = -(two_al * ex + w) * rinv;
          const float coef = gh * (pq * s.q[l]) * dw * rinv;
          gx += coef * dx;
          gy += coef * dy;
          gz += coef * dz;
          gq += gh * w * s.q[l];
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        gx += __shfl_xor_sync(kFull, gx, off);
        gy += __shfl_xor_sync(kFull, gy, off);
        gz += __shfl_xor_sync(kFull, gz, off);
        gq += __shfl_xor_sync(kFull, gq, off);
      }
    }
    if (lane == 0) {
      const size_t crow = (size_t)cell * p.c + row;
      dctr[crow * 4] = -gx;
      dctr[crow * 4 + 1] = -gy;
      dctr[crow * 4 + 2] = -gz;
      dctr[crow * 4 + 3] = gq;
    }
  }

  // Pass 2: a thread per window lane, the lane's cotangent over all rows.
  const size_t plane = (size_t)p.ncells * p.kk;
  const size_t base = (size_t)cell * p.kk;
  for (int l = threadIdx.x; l < p.kk; l += kThreads) {
    const float lx = s.x[l], ly = s.y[l], lz = s.z[l], lq = s.q[l];
    const int sid = s.sid[l];
    float ax = 0.f, ay = 0.f, az = 0.f, aq = 0.f;
    for (int row = 0; row < p.c && lx < kEmpty; ++row) {
      const float px = sc[4 * row];
      if (px >= kEmpty) continue;
      const float dx = lx - px, dy = ly - sc[4 * row + 1],
                  dz = lz - sc[4 * row + 2];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < p.rc2 && pairs_with(sid, cell, row, p, s)) {
        const float pq = sc[4 * row + 3], gh = sg[row];
        const float r = sqrtf(fmaxf(d2, 1e-12f));
        const float rinv = 1.f / r;
        const float x = p.alpha * r;
        const float ex = expf(-x * x);
        const float w = erfc_poly(x, ex) * rinv;
        const float dw = -(two_al * ex + w) * rinv;
        const float coef = gh * (pq * lq) * dw * rinv;
        ax += coef * dx;
        ay += coef * dy;
        az += coef * dz;
        aq += gh * w * pq;
      }
    }
    dcand[base + l] = ax;
    dcand[plane + base + l] = ay;
    dcand[2 * plane + base + l] = az;
    dcand[3 * plane + base + l] = aq;
  }
}

int make_params(PmeParams& p, int ncells, int nx, int ny, int nz, int c,
                int ne, double cutoff, double alpha, double coulomb) {
  if (nx < 3 || ny < 3 || nz < 3 || ncells != nx * ny * nz || c < 1 ||
      ne < 1 || cutoff <= 0 || alpha <= 0)
    return (int)cudaErrorInvalidValue;
  p.ncells = ncells;
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  p.c = c;
  p.kk = 27 * c;
  p.ne = ne;
  p.rc2 = (float)(cutoff * cutoff);
  p.alpha = (float)alpha;
  p.half_ke = (float)(0.5 * coulomb);
  return 0;
}

size_t stage_bytes(const PmeParams& p) {
  return 4 * (size_t)p.kk * sizeof(float) + (size_t)p.kk * sizeof(int) +
         (size_t)p.c * p.ne * sizeof(int);
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int pme_window_fwd(const float* cx, const float* cy, const float* cz,
                   const float* cq, const float* centers, const int* excl,
                   float* out, int ncells, int nx, int ny, int nz, int c,
                   int ne, double cutoff, double alpha, double coulomb,
                   void* stream) {
  PmeParams p;
  const int bad = make_params(p, ncells, nx, ny, nz, c, ne, cutoff, alpha,
                              coulomb);
  if (bad) return bad;
  const size_t smem = stage_bytes(p);
  cudaError_t err = prepare(pme_window_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pme_window_fwd_kernel<<<ncells, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, cz, cq, centers, excl, out, p);
  return (int)cudaGetLastError();
}

int pme_window_bwd(const float* cx, const float* cy, const float* cz,
                   const float* cq, const float* centers, const int* excl,
                   const float* g, float* dcand, float* dctr, int ncells,
                   int nx, int ny, int nz, int c, int ne, double cutoff,
                   double alpha, double coulomb, void* stream) {
  PmeParams p;
  const int bad = make_params(p, ncells, nx, ny, nz, c, ne, cutoff, alpha,
                              coulomb);
  if (bad) return bad;
  const size_t smem = stage_bytes(p) + 5 * (size_t)c * sizeof(float);
  cudaError_t err = prepare(pme_window_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pme_window_bwd_kernel<<<ncells, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, cz, cq, centers, excl, g, dcand, dctr, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
