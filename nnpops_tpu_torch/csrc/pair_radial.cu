// Symmetric z-pair radial AEV, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_zpair.py:60
// _make_pair_kernels: fwd_kernel (pallas_call at :219) and bwd_kernel
// (:233). Wrapper, autograd Function, plain PyTorch version and the host
// side (z-triple build, shifts, fold): nnpops_tpu_torch/ops/cuda_zpair.py.
//
// Semantics, per cell a of an nx x ny x nz grid with c species-sub-blocked
// slots (species s owns rows [row_off[s], row_off[s+1])):
// * lanes are z-triples: z3[b] holds, per species s, the slots of cells
//   (b, z-1 | z | z+1), L = 3c lanes, species s on [3 off_s, 3 off_{s+1});
// * the cell's center rows meet the z-triples of five columns b_d: the
//   self column (d = 0) and the half xy-offsets (1,0), (0,1), (1,1),
//   (1,-1), whose periodic image shift shift[a, d-1] is added to the
//   lanes; the self lane of row r (d = 0) is r + 2 off_s + cs;
// * a pair is valid when d2 < rc^2; fc = 0.5 cos(pi r / rc) + 0.5;
// * out_a[a, r, s_l*R + q] = scale * sum over the five columns and the
//   lanes of species s_l of fc * exp(-eta_q (r - rs_q)^2);
// * out_b[a, d-1, s_r*R + q, l] = scale * sum over the rows of species s_r
//   of the same term (the neighbour side of the four half offsets, folded
//   onto the neighbours' home cells by the wrapper).
// The backward recomputes the geometry and writes dctr [ncells, c, 3],
// one dz3 plane per offset at the column's cell (dz5 [5, ncells, 3, L],
// summed by the wrapper) and the shift cotangent dsh [ncells, 4, 3].
// Centers at or beyond FAR/2 are empty slots: their rows are 0 and they
// evaluate no pair (the Pallas kernel pairs them with the empty lanes of
// their own column, d = 0, and writes rows no caller reads).
//
// What bounds it on the H100: bytes. Every (center row, lane) pair of the
// five columns is tested (about 10 operations) and a valid pair costs a
// sqrt, a cosine and R = 16 Gaussians (about 100 operations forward, 150
// backward): about 0.2 M operations a cell at 2,601 atoms. The cell's
// z-triples and centers come in, c x P*R + 4 x P*R x L floats go out, and
// out_b dominates (49 KB a cell at c = 32), so the bytes take longer than
// the operations at the card's rates. The neighbour side is written, not
// added into other cells, to keep the sums free of atomics.
//
// Design: one block of 8 warps per cell. The five z-triples (shifts
// added), the centers and per-warp row sums live in shared memory. Work
// items are (column d, chunk of <= 32 lanes inside one species block);
// warp w takes items w, w + 8, ... A lane owns one lane of the chunk and
// walks every center row in order: the neighbour-side sums of out_b (and
// the lane cotangents of the backward) accumulate in its registers over
// the rows of one species and are written once, without atomics. The
// center-side sums are reduced over the chunk by warp shuffles and added
// to the warp's own shared row sums; the block adds the 8 warps' sums in
// warp order at the end. Every sum has a fixed order: two calls are
// bitwise equal. A row whose chunk holds no valid pair (a ballot) costs
// one distance test per lane.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSpecies = 8;
constexpr int kMaxRadial = 16;
constexpr int kMaxChunks = 64;
constexpr int kOffsets = 5;
constexpr float kEmptyRow = 0.5e6f;     // FAR / 2
constexpr unsigned kFull = 0xffffffffu;

struct PairParams {
  int ncells, nx, ny, nz, c, ll, npres, n_r, out_w, n_chunks;
  float rc, rc2, pi_rc, scale;
  int row_off[kMaxSpecies + 1];     // center rows of each species
  int self_shift[kMaxSpecies];      // self lane = row + self_shift[s]
  int chunk_lo[kMaxChunks], chunk_hi[kMaxChunks], chunk_sp[kMaxChunks];
  float eta[kMaxRadial], rs[kMaxRadial];
};

// The cell of column d of cell a: the xy half offset, same z.
__device__ __forceinline__ int column_cell(int a, int d, const PairParams& p) {
  // HALF_OFFSETS: (0,0), (1,0), (0,1), (1,1), (1,-1).
  const int ox = (d == 1 || d >= 3) ? 1 : 0;
  const int oy = (d == 2 || d == 3) ? 1 : (d == 4 ? -1 : 0);
  const int az = a % p.nz, axy = a / p.nz;
  const int ay = axy % p.ny, ax = axy / p.ny;
  const int bx = (ax + ox + p.nx) % p.nx, by = (ay + oy + p.ny) % p.ny;
  return (bx * p.ny + by) * p.nz + az;
}

// Stage the five z-triples of cell a (shift added to the four half
// offsets, as the Pallas kernel adds it: (z + shift) - center) and the
// cell's centers.
__device__ __forceinline__ void stage(const float* __restrict__ ctr,
                                      const float* __restrict__ z3,
                                      const float* __restrict__ shift, int a,
                                      const PairParams& p, float* zs,
                                      float* cs) {
  const int n3 = 3 * p.ll;
  for (int i = threadIdx.x; i < kOffsets * n3; i += kThreads) {
    const int d = i / n3, j = i - d * n3, comp = j / p.ll;
    const float z = z3[(size_t)column_cell(a, d, p) * n3 + j];
    zs[i] = d == 0 ? z : z + shift[((size_t)a * 4 + d - 1) * 3 + comp];
  }
  for (int i = threadIdx.x; i < 3 * p.c; i += kThreads)
    cs[i] = ctr[(size_t)a * 3 * p.c + i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
pair_radial_fwd_kernel(const float* __restrict__ ctr,
                       const float* __restrict__ z3,
                       const float* __restrict__ shift,
                       float* __restrict__ out_a, float* __restrict__ out_b,
                       const PairParams p) {
  extern __shared__ float smem[];
  float* zs = smem;                                  // [5][3][ll]
  float* cs = zs + kOffsets * 3 * p.ll;              // [c][3]
  float* part = cs + 3 * p.c;                        // [kWarps][c][out_w]
  const int a = blockIdx.x;
  stage(ctr, z3, shift, a, p, zs, cs);
  for (int i = threadIdx.x; i < kWarps * p.c * p.out_w; i += kThreads)
    part[i] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wpart = part + (size_t)warp * p.c * p.out_w;

  for (int item = warp; item < kOffsets * p.n_chunks; item += kWarps) {
    const int d = item / p.n_chunks, ch = item - d * p.n_chunks;
    const int l = p.chunk_lo[ch] + lane, s_l = p.chunk_sp[ch];
    const bool on = l < p.chunk_hi[ch];
    const float* zd = zs + d * 3 * p.ll;
    const float lx = on ? zd[l] : 0.f, ly = on ? zd[p.ll + l] : 0.f,
                lz = on ? zd[2 * p.ll + l] : 0.f;
    for (int s_r = 0; s_r < p.npres; ++s_r) {
      float accb[kMaxRadial];
#pragma unroll
      for (int q = 0; q < kMaxRadial; ++q) accb[q] = 0.f;
      for (int r = p.row_off[s_r]; r < p.row_off[s_r + 1]; ++r) {
        const float px = cs[3 * r], py = cs[3 * r + 1], pz = cs[3 * r + 2];
        const float dx = lx - px, dy = ly - py, dz = lz - pz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const bool valid = on && px < kEmptyRow && d2 < p.rc2 &&
                           !(d == 0 && l == r + p.self_shift[s_r]);
        if (!__ballot_sync(kFull, valid)) continue;
        const float rr = sqrtf(fmaxf(d2, 1e-12f));
        const float fc = valid ? 0.5f * cosf(p.pi_rc * rr) + 0.5f : 0.f;
        const float rm = fminf(rr, p.rc);
#pragma unroll
        for (int q = 0; q < kMaxRadial; ++q) {
          if (q < p.n_r) {
            const float u = rm - p.rs[q];
            const float v = fc * expf(-p.eta[q] * (u * u));
            accb[q] += v;
            const float w = warp_sum(v);
            if (lane == 0) wpart[r * p.out_w + s_l * p.n_r + q] += w;
          }
        }
      }
      if (d > 0 && on) {
        float* ob = out_b + (((size_t)a * 4 + d - 1) * p.out_w + s_r * p.n_r)
                                * p.ll + l;
#pragma unroll
        for (int q = 0; q < kMaxRadial; ++q)
          if (q < p.n_r) ob[(size_t)q * p.ll] = p.scale * accb[q];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.c * p.out_w; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[(size_t)w * p.c * p.out_w + i];
    out_a[(size_t)a * p.c * p.out_w + i] = p.scale * s;
  }
}

__global__ void __launch_bounds__(kThreads)
pair_radial_bwd_kernel(const float* __restrict__ ctr,
                       const float* __restrict__ z3,
                       const float* __restrict__ shift,
                       const float* __restrict__ ga,
                       const float* __restrict__ gb,
                       float* __restrict__ dctr, float* __restrict__ dz5,
                       float* __restrict__ dsh, const PairParams p) {
  extern __shared__ float smem[];
  float* zs = smem;                                  // [5][3][ll]
  float* cs = zs + kOffsets * 3 * p.ll;              // [c][3]
  float* gas = cs + 3 * p.c;                         // [c][out_w]
  float* partc = gas + p.c * p.out_w;                // [kWarps][c][3]
  float* parts = partc + kWarps * 3 * p.c;           // [kWarps][4][3]
  const int a = blockIdx.x;
  stage(ctr, z3, shift, a, p, zs, cs);
  for (int i = threadIdx.x; i < p.c * p.out_w; i += kThreads)
    gas[i] = ga[(size_t)a * p.c * p.out_w + i];
  for (int i = threadIdx.x; i < kWarps * (3 * p.c + 12); i += kThreads)
    partc[i] = 0.f;                                  // partc and parts
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t plane = (size_t)p.ncells * 3 * p.ll;

  for (int item = warp; item < kOffsets * p.n_chunks; item += kWarps) {
    const int d = item / p.n_chunks, ch = item - d * p.n_chunks;
    const int l = p.chunk_lo[ch] + lane, s_l = p.chunk_sp[ch];
    const bool on = l < p.chunk_hi[ch];
    const float* zd = zs + d * 3 * p.ll;
    const float lx = on ? zd[l] : 0.f, ly = on ? zd[p.ll + l] : 0.f,
                lz = on ? zd[2 * p.ll + l] : 0.f;
    float sx = 0.f, sy = 0.f, sz = 0.f;           // this lane's row sums
    for (int s_r = 0; s_r < p.npres; ++s_r) {
      float gbq[kMaxRadial];
      const float* gbr =
          d > 0 ? gb + (((size_t)a * 4 + d - 1) * p.out_w + s_r * p.n_r)
                           * p.ll + l
                : gb;
#pragma unroll
      for (int q = 0; q < kMaxRadial; ++q)
        gbq[q] = (d > 0 && on && q < p.n_r) ? gbr[(size_t)q * p.ll] : 0.f;
      for (int r = p.row_off[s_r]; r < p.row_off[s_r + 1]; ++r) {
        const float px = cs[3 * r], py = cs[3 * r + 1], pz = cs[3 * r + 2];
        const float dx = lx - px, dy = ly - py, dz = lz - pz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const bool valid = on && px < kEmptyRow && d2 < p.rc2 &&
                           !(d == 0 && l == r + p.self_shift[s_r]);
        if (!__ballot_sync(kFull, valid)) continue;
        float gx = 0.f, gy = 0.f, gz = 0.f;
        if (valid) {
          const float rr = sqrtf(fmaxf(d2, 1e-12f));
          const float fc = 0.5f * cosf(p.pi_rc * rr) + 0.5f;
          const float dfc = -0.5f * p.pi_rc * sinf(p.pi_rc * rr);
          const float rm = fminf(rr, p.rc);
          const float* gar = gas + r * p.out_w + s_l * p.n_r;
          float acc = 0.f, bcc = 0.f;
#pragma unroll
          for (int q = 0; q < kMaxRadial; ++q) {
            if (q < p.n_r) {
              const float u = rm - p.rs[q];
              const float ge = (gar[q] + gbq[q]) * expf(-p.eta[q] * (u * u));
              acc += ge;
              bcc += ge * (p.eta[q] * (rr - p.rs[q]));
            }
          }
          const float coef = p.scale * (dfc * acc - 2.f * fc * bcc) / rr;
          gx = coef * dx;
          gy = coef * dy;
          gz = coef * dz;
        }
        sx += gx;
        sy += gy;
        sz += gz;
        const float cx = warp_sum(gx), cy = warp_sum(gy), cz = warp_sum(gz);
        if (lane == 0) {
          float* pc = partc + (warp * p.c + r) * 3;
          pc[0] -= cx;
          pc[1] -= cy;
          pc[2] -= cz;
        }
      }
    }
    if (on) {
      float* dz = dz5 + d * plane + (size_t)column_cell(a, d, p) * 3 * p.ll + l;
      dz[0] = sx;
      dz[p.ll] = sy;
      dz[2 * p.ll] = sz;
    }
    if (d > 0) {
      const float tx = warp_sum(sx), ty = warp_sum(sy), tz = warp_sum(sz);
      if (lane == 0) {
        float* ps = parts + (warp * 4 + d - 1) * 3;
        ps[0] += tx;
        ps[1] += ty;
        ps[2] += tz;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * p.c; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += partc[w * 3 * p.c + i];
    dctr[(size_t)a * 3 * p.c + i] = s;
  }
  for (int i = threadIdx.x; i < 12; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += parts[w * 12 + i];
    dsh[(size_t)a * 12 + i] = s;
  }
}

// The row and lane geometry comes from the wrapper (cuda_zpair.py, whose
// plain version uses the same tables); it is checked here: rows and
// z-triple lane blocks tile [0, c) and [0, 3c), every chunk lies inside its
// species' lane block, and every row's self lane lies inside its block.
int make_params(PairParams& p, int nx, int ny, int nz, int npres,
                const int* row_off, int n_chunks, const int* chunk_lo,
                const int* chunk_hi, const int* chunk_sp, int n_r,
                const float* eta, const float* rs, double rc, double scale) {
  if (nx < 3 || ny < 3 || nz < 3 || npres < 1 || npres > kMaxSpecies ||
      n_r < 1 || n_r > kMaxRadial || n_chunks < 1 || n_chunks > kMaxChunks ||
      row_off[0] != 0)
    return (int)cudaErrorInvalidValue;
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  p.ncells = nx * ny * nz;
  p.npres = npres;
  p.c = row_off[npres];
  p.ll = 3 * p.c;
  p.n_r = n_r;
  p.out_w = npres * n_r;
  p.n_chunks = n_chunks;
  p.rc = (float)rc;
  p.rc2 = (float)(rc * rc);
  p.pi_rc = (float)(3.14159265358979323846 / rc);
  p.scale = (float)scale;
  for (int s = 0; s <= kMaxSpecies; ++s)
    p.row_off[s] = s <= npres ? row_off[s] : p.c;
  for (int s = 0; s < kMaxSpecies; ++s) {
    const int cs = s < npres ? row_off[s + 1] - row_off[s] : 0;
    if (cs < 0) return (int)cudaErrorInvalidValue;
    p.self_shift[s] = s < npres ? 2 * row_off[s] + cs : 0;
  }
  int covered = 0;
  for (int i = 0; i < kMaxChunks; ++i) {
    const bool on = i < n_chunks;
    p.chunk_lo[i] = on ? chunk_lo[i] : 0;
    p.chunk_hi[i] = on ? chunk_hi[i] : 0;
    p.chunk_sp[i] = on ? chunk_sp[i] : 0;
    if (!on) continue;
    const int s = chunk_sp[i];
    if (s < 0 || s >= npres || chunk_lo[i] != covered ||
        chunk_hi[i] <= chunk_lo[i] || chunk_hi[i] - chunk_lo[i] > 32 ||
        chunk_lo[i] < 3 * row_off[s] || chunk_hi[i] > 3 * row_off[s + 1])
      return (int)cudaErrorInvalidValue;
    covered = chunk_hi[i];
  }
  if (covered != p.ll) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxRadial; ++i) {
    p.eta[i] = i < n_r ? eta[i] : 0.f;
    p.rs[i] = i < n_r ? rs[i] : 0.f;
  }
  return 0;
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

int pair_radial_fwd(const float* ctr, const float* z3, const float* shift,
                    float* out_a, float* out_b, int nx, int ny, int nz,
                    int npres, const int* row_off, int n_chunks,
                    const int* chunk_lo, const int* chunk_hi,
                    const int* chunk_sp, int n_r, const float* eta,
                    const float* rs, double rc, double scale, void* stream) {
  PairParams p;
  const int bad = make_params(p, nx, ny, nz, npres, row_off, n_chunks,
                              chunk_lo, chunk_hi, chunk_sp, n_r, eta, rs, rc,
                              scale);
  if (bad) return bad;
  const size_t smem = (kOffsets * 3 * (size_t)p.ll + 3 * (size_t)p.c +
                       (size_t)kWarps * p.c * p.out_w) * sizeof(float);
  cudaError_t err = prepare(pair_radial_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pair_radial_fwd_kernel<<<p.ncells, kThreads, smem, (cudaStream_t)stream>>>(
      ctr, z3, shift, out_a, out_b, p);
  return (int)cudaGetLastError();
}

int pair_radial_bwd(const float* ctr, const float* z3, const float* shift,
                    const float* ga, const float* gb, float* dctr, float* dz5,
                    float* dsh, int nx, int ny, int nz, int npres,
                    const int* row_off, int n_chunks, const int* chunk_lo,
                    const int* chunk_hi, const int* chunk_sp, int n_r,
                    const float* eta, const float* rs, double rc,
                    double scale, void* stream) {
  PairParams p;
  const int bad = make_params(p, nx, ny, nz, npres, row_off, n_chunks,
                              chunk_lo, chunk_hi, chunk_sp, n_r, eta, rs, rc,
                              scale);
  if (bad) return bad;
  const size_t smem =
      (kOffsets * 3 * (size_t)p.ll + 3 * (size_t)p.c +
       (size_t)p.c * p.out_w + (size_t)kWarps * (3 * p.c + 12)) *
      sizeof(float);
  cudaError_t err = prepare(pair_radial_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pair_radial_bwd_kernel<<<p.ncells, kThreads, smem, (cudaStream_t)stream>>>(
      ctr, z3, shift, ga, gb, dctr, dz5, dsh, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
