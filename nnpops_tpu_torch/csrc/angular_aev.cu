// Angular AEV over species-blocked neighbor lanes, forward and backward,
// for sm_90a.
//
// Replaces the Pallas TPU kernel nnpops_tpu/ops/pallas_aev.py:76
// make_angular_kernel (pl.pallas_call at :614 and :626): fwd_kernel (:405) /
// fwd_kernel_rad (:409) and bwd_kernel (:557) / bwd_kernel_rad (:565), with
// pow_impl='split', fc_impl='poly'. Wrapper, autograd Function and plain
// PyTorch version: nnpops_tpu_torch/ops/cuda_aev.py.
//
// What bounds it on the H100: the SFU, then FP32. A triple (j, k) whose two
// lanes are inside the cutoff costs 18 MUFU operations in either direction
// at the (8, 4) grid: one rcp for 1/(r_j r_k), one rsqrt for the sine,
// n_ts lg2 + ex2 pairs for the fractional power and n_rs ex2 for the
// Gaussians. The SFU issues 16 a clock per SM, the FP32 pipes 128; the
// backward's FP32 work (two 32-term contractions with the cotangents) takes
// longer than its MUFU work. The bytes are small (a row's <= Kat lanes of
// three planes in, n_seg * A floats out).
//
// What the design does about it:
// - A warp per row, several rows a block: rows are independent, so a row's
//   work needs only __syncwarp. Per-lane quantities (coordinates after the
//   mask push, clamped r, fc, and in the backward dfc/dr and 1/r) are
//   computed once per lane into the warp's shared memory; the row's loads
//   all go out before the first is used.
// - Only valid lanes (r < ra after the mask push, as in the plain version)
//   are kept: each species block is compacted in lane order with
//   __ballot_sync/__popc, and each species-pair segment enumerates its
//   triples over the compacted lists (n(n-1)/2 within a block, n_i n_j
//   across blocks). No thread spends a slot on a triple that contributes
//   an exact 0.
// - A triple's body has no branch but a rare one (below): the integer
//   part of zeta is a template parameter for ANI's zeta (14.1), so the
//   binary exponentiation unrolls, and the MUFU work is inline PTX.
// - Forward: each thread keeps the segment's A sums in registers; a
//   reduce-scatter across the warp (16 + 8 + 4 + 2 + 1 shuffle-adds at
//   A = 32; A = 9 pads to 16) leaves lane l with column l, stored
//   coalesced.
// - Backward: no float atomics. The triples of a segment go in chunks of
//   kChunk; each writes its j-side and k-side cotangents into the warp's
//   buffer at its position in the enumeration, then each thread sums the
//   entries of the compacted lanes it owns in ascending position (a row of
//   the triangle or rectangle is contiguous, a column has a closed form).
//   P_zeta and P_(zeta-1) come from one lg2/ex2 pair.
// Every sum runs in a fixed order: both directions are bitwise repeatable.
//
// The quantities that decide a branch of the plain version (r < ra, the
// clamps of r, of the cosine at 0.95 or 1 and of |d_j x d_k|^2 at 1e-12)
// are rounded op by op as PyTorch rounds them (__fmul_rn/__fadd_rn), so the
// kernel takes the same branch; 1/(r_j r_k) comes from rcp.approx and one
// Newton step, and is recomputed correctly rounded (__frcp_rn) only when
// the cosine lies within 1e-5 of its clamp. The rest may contract to FMA.
// Intrinsics (inline PTX, flush to zero): ex2.approx for the Gaussians and
// the fractional power, lg2.approx for its logarithm (whose error the
// fractional part, 0.1 at ANI-2x, scales down), rsqrt.approx for the sine
// and |d_j x d_k| and their reciprocals, rcp.approx for 1/(r_j r_k).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxGrid = 16;
constexpr int kMaxBlocks = 8;     // species blocks of a layout
constexpr int kMaxWarps = 4;      // rows (warps) per thread block
constexpr int kMinBlocks = 264;   // two thread blocks per SM on 132 SMs
constexpr int kChunk = 256;       // backward triples per buffer fill
constexpr int kZetaBits = 8;      // integer part of zeta - 1 below 2^8
constexpr int kAniZi1 = 13;       // integer part of ANI's zeta (14.1) - 1
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk % 32 == 0, "a chunk is whole steps of the warp");

struct AngParams {
  int n_rows, width, kat, n_blk, n_seg;
  int blk_cap[kMaxBlocks];   // lanes of each species block
  int blk_pos[kMaxBlocks];   // input column of each block's first lane
  float ra, far, inv_ra2, two_inv_ra2, neg_eta, neg_eta_log2e, zeta;
  int zi1;      // integer part of zeta - 1 (zeta >= 1)
  float zf;     // fractional part of zeta (and of zeta - 1); 0 if none
  int torchani;
  float rs[kMaxGrid], cts[kMaxGrid], sts[kMaxGrid];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
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

__host__ __device__ constexpr int bit_length(int v) {
  return v > 0 ? 1 + bit_length(v >> 1) : 0;
}

// fc(t), t = (r/ra)^2: Horner chain of the degree-8 fit (FC_COEFFS in
// cuda_aev.py), coefficients rounded to f32 as in the reference.
__device__ __forceinline__ float fc_poly_t(float t) {
  float p = 1.8597632061664595e-06f;
  p = p * t + -5.1784521003695567e-05f;
  p = p * t + 0.00096425294148109802f;
  p = p * t + -0.012903133084020298f;
  p = p * t + 0.11766520747089387f;
  p = p * t + -0.66763136355346187f;
  p = p * t + 2.0293560611802657f;
  p = p * t + -2.4674011001964282f;
  p = p * t + 0.99999999999953115f;
  return p;
}

// d fc / dt: coefficient k of the derivative is FC_COEFFS[k] * k.
__device__ __forceinline__ float dfc_poly_t(float t) {
  float p = (float)(1.8597632061664595e-06 * 8);
  p = p * t + (float)(-5.1784521003695567e-05 * 7);
  p = p * t + (float)(0.00096425294148109802 * 6);
  p = p * t + (float)(-0.012903133084020298 * 5);
  p = p * t + (float)(0.11766520747089387 * 4);
  p = p * t + (float)(-0.66763136355346187 * 3);
  p = p * t + (float)(2.0293560611802657 * 2);
  p = p * t + (float)(-2.4674011001964282 * 1);
  return p;
}

// base^(zeta - 1) for every theta_s: binary exponentiation for the integer
// part (ZI1, or p.zi1 at run time where ZI1 < 0), exp of zf log(base) only
// for the fractional part (a plain powf of 14.1 amplifies log's error
// about 14x); base^zeta is this times base. With zf = 0 the factor is
// ex2(0) = 1 exactly.
template <int NTS, int ZI1>
__device__ __forceinline__ void pow_zeta1(const float (&base)[NTS],
                                          float (&q)[NTS],
                                          const AngParams& p) {
  float sq[NTS];
#pragma unroll
  for (int ts = 0; ts < NTS; ++ts) {
    q[ts] = 1.f;
    sq[ts] = base[ts];
  }
  if constexpr (ZI1 >= 0) {
    constexpr int kBits = bit_length(ZI1);
#pragma unroll
    for (int bit = 0; bit < kBits; ++bit) {
#pragma unroll
      for (int ts = 0; ts < NTS; ++ts) {
        if ((ZI1 >> bit) & 1) q[ts] *= sq[ts];
        if (bit + 1 < kBits) sq[ts] *= sq[ts];
      }
    }
  } else {
#pragma unroll
    for (int bit = 0; bit < kZetaBits; ++bit) {
      if ((p.zi1 >> bit) == 0) break;
      const bool on = (p.zi1 >> bit) & 1;
#pragma unroll
      for (int ts = 0; ts < NTS; ++ts) {
        if (on) q[ts] *= sq[ts];
        sq[ts] *= sq[ts];
      }
    }
  }
#pragma unroll
  for (int ts = 0; ts < NTS; ++ts) q[ts] *= ex2(p.zf * lg2(base[ts]));
}

// One row's lanes in the warp's shared memory, indexed by compacted
// position (valid lanes of block 0, then block 1, ...).
struct RowLanes {
  float4* q;     // x, y, z, r (r clamped to >= 1e-3)
  float4* aux;   // fc, dfc/dr, 1/r, d r/d|x| factor (1/r, 0 where clamped)
  int* nv;       // [kMaxBlocks] valid lanes per block
  int* cpos;     // [kat] compacted position of each lane, -1 if invalid
};

// Per-lane quantities of one row, compacted per species block. Masked
// lanes move `far` away in x so they fail r < ra on their own. Returns the
// number of valid lanes.
template <bool kBwd>
__device__ int stage_row(const float* __restrict__ planes,
                         const uint8_t* __restrict__ mask, int row,
                         const AngParams& p, const RowLanes& L, int lane) {
  const size_t plane = (size_t)p.n_rows * p.width;
  const float* px = planes + (size_t)row * p.width;
  const uint8_t* mrow = mask + (size_t)row * p.kat;
  // Every lane's coordinates into q[l] first, all loads in flight at once.
  {
    int b = 0, off = 0;
#pragma unroll 2
    for (int l = lane; l < p.kat; l += 32) {
      while (l >= off + p.blk_cap[b]) off += p.blk_cap[b++];
      const int col = p.blk_pos[b] + (l - off);
      const float x0 = px[col], y = px[plane + col], z = px[2 * plane + col];
      const float x = mrow[l] ? x0 : __fadd_rn(x0, p.far);
      L.q[l] = make_float4(x, y, z, 0.f);
    }
  }
  __syncwarp();
  // Then compaction in place: a lane's compacted position never exceeds
  // its own, and a round reads all its lanes before any write.
  int total = 0, off = 0;
  for (int b = 0; b < p.n_blk; ++b) {
    const int cap = p.blk_cap[b];
    int cnt = 0;
    for (int base = 0; base < cap; base += 32) {
      const int l = off + base + lane;
      const bool in = base + lane < cap;
      const float4 v = in ? L.q[l] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float r_raw = __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
          __fmul_rn(v.z, v.z)));
      const bool valid = in && r_raw < p.ra;
      const unsigned bal = __ballot_sync(kFull, valid);
      const int pos = total + cnt + __popc(bal & ((1u << lane) - 1u));
      if (valid) {
        const float r = fmaxf(r_raw, 1e-3f);
        const float t_raw = __fmul_rn(__fmul_rn(r, r), p.inv_ra2);
        const float t = fminf(t_raw, 1.f);
        L.q[pos] = make_float4(v.x, v.y, v.z, r);
        float4 a = make_float4(fc_poly_t(t), 0.f, 0.f, 0.f);
        if (kBwd) {
          a.y = t_raw <= 1.f ? dfc_poly_t(t) * p.two_inv_ra2 * r : 0.f;
          a.z = 1.f / r;
          a.w = r_raw >= 1e-3f ? a.z : 0.f;
        }
        L.aux[pos] = a;
      }
      if (kBwd && in) L.cpos[l] = valid ? pos : -1;
      cnt += __popc(bal);
    }
    if (lane == 0) L.nv[b] = cnt;
    total += cnt;
    off += cap;
  }
  __syncwarp();
  return total;
}

// The triples of one segment in enumeration order: within a block (a, b)
// with a < b < ni row-major (np.triu_indices), across blocks the ni x nj
// rectangle row-major; a thread starts at position `lane` and steps by 32.
struct SegmentWalk {
  bool same;
  int ni, nj, a, off;   // same: row a, offset in the row; else (a, off)
  float inv_nj;
  __device__ void init(bool same_, int ni_, int nj_, int start) {
    same = same_;
    ni = ni_;
    nj = nj_;
    inv_nj = same || nj == 0 ? 0.f : 1.f / (float)nj;
    a = off = 0;
    advance(start);
  }
  // The current pair, compacted within their blocks.
  __device__ int first() const { return a; }
  __device__ int second() const { return same ? a + 1 + off : off; }
  __device__ void advance(int s) {
    if (same) {
      off += s;
      while (a < ni - 1 && off >= ni - 1 - a) {
        off -= ni - 1 - a;
        ++a;
      }
    } else {
      // t = a nj + off; the float quotient is exact for t < 2^21.
      const int t = a * nj + off + s;
      a = __float2int_rz(((float)t + 0.5f) * inv_nj);
      off = t - a * nj;
    }
  }
};

// Position of (a, a + 1) in the triangle of n lanes.
__device__ __forceinline__ int tri_row_start(int a, int n) {
  return a * (2 * n - a - 1) / 2;
}

struct Geometry {
  float cos_t, sin_t, inv12, rm, vf;
  float inv_sin;                 // torchani mode: 1/sin
  bool cos_ok;                   // inside the cosine's clamp
  float cx, cy, cz, inv_cnorm;   // publication mode: d_j x d_k, 1/|.|
  bool c_ok;                     // |c|^2 >= 1e-12
};

__device__ __forceinline__ Geometry geometry(const float4& A, float fa,
                                             const float4& B, float fb,
                                             const AngParams& p) {
  Geometry g;
  const float dot12 = __fadd_rn(__fadd_rn(__fmul_rn(A.x, B.x),
                                          __fmul_rn(A.y, B.y)),
                                __fmul_rn(A.z, B.z));
  const float r12 = __fmul_rn(A.w, B.w);
  // The cosine's clamp: 0.95 with torchani's 0.95 dot scale, else 1
  // (fl(1 * dot) = dot).
  const float lim = p.torchani ? 0.95f : 1.f;
  const float y = rcp_approx(r12);
  g.inv12 = fmaf(fmaf(-r12, y, 1.f), y, y);
  float raw = __fmul_rn(__fmul_rn(lim, dot12), g.inv12);
  if (fabsf(raw) > 0.99999f * lim) {
    // Near the clamp: round 1/(r1 r2) as PyTorch does, so that the clamp
    // takes the plain version's branch.
    g.inv12 = __frcp_rn(r12);
    raw = __fmul_rn(__fmul_rn(lim, dot12), g.inv12);
  }
  g.cos_ok = raw >= -lim && raw <= lim;
  g.cos_t = fminf(fmaxf(raw, -lim), lim);
  if (p.torchani) {
    // sin = sqrt(1 - cos^2) >= sqrt(1 - 0.95^2).
    const float s2 = 1.f - g.cos_t * g.cos_t;
    g.inv_sin = rsqrt_approx(s2);
    g.sin_t = s2 * g.inv_sin;
    g.cx = g.cy = g.cz = g.inv_cnorm = 0.f;
    g.c_ok = false;
  } else {
    g.cx = __fsub_rn(__fmul_rn(A.y, B.z), __fmul_rn(A.z, B.y));
    g.cy = __fsub_rn(__fmul_rn(A.z, B.x), __fmul_rn(A.x, B.z));
    g.cz = __fsub_rn(__fmul_rn(A.x, B.y), __fmul_rn(A.y, B.x));
    const float csq = __fadd_rn(__fadd_rn(__fmul_rn(g.cx, g.cx),
                                          __fmul_rn(g.cy, g.cy)),
                                __fmul_rn(g.cz, g.cz));
    g.c_ok = csq >= 1e-12f;
    const float m = fmaxf(csq, 1e-12f);
    g.inv_cnorm = rsqrt_approx(m);
    g.sin_t = m * g.inv_cnorm * g.inv12;
    g.inv_sin = 0.f;
  }
  g.rm = 0.5f * (A.w + B.w);
  g.vf = fa * fb;
  return g;
}

template <int NRS, int NTS, int ZI1, int NPAD>
__device__ __forceinline__ void fwd_triple(const float4& A, float fa,
                                           const float4& B, float fb,
                                           const AngParams& p,
                                           float (&acc)[NPAD]) {
  const Geometry g = geometry(A, fa, B, fb, p);
  float base[NTS], P[NTS];
#pragma unroll
  for (int ts = 0; ts < NTS; ++ts)
    base[ts] =
        fmaxf(1.f + (g.cos_t * p.cts[ts] + g.sin_t * p.sts[ts]), 1e-20f);
  pow_zeta1<NTS, ZI1>(base, P, p);
#pragma unroll
  for (int ts = 0; ts < NTS; ++ts) P[ts] *= base[ts];
#pragma unroll
  for (int rs = 0; rs < NRS; ++rs) {
    const float u = g.rm - p.rs[rs];
    const float e = g.vf * ex2(p.neg_eta_log2e * (u * u));
#pragma unroll
    for (int ts = 0; ts < NTS; ++ts) acc[rs * NTS + ts] += e * P[ts];
  }
}

// One step of the reduce-scatter: lanes with bit H set keep the upper H of
// their 2H sums, the others the lower H, each plus its partner's copy. H is
// a template parameter so that every index is a constant and v stays in
// registers.
template <int H, int N>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[N], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i], hi = v[i + H];
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, H);
  }
  if constexpr (H > 1) reduce_scatter_step<H / 2>(v, lane);
}

// Reduce-scatter of N (a power of two <= 32) per-lane sums across the warp:
// returns column lane & (N - 1) summed over all 32 lanes, in a fixed order.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  reduce_scatter_step<N / 2>(v, lane);
  float r = v[0];
#pragma unroll
  for (int o = N; o < 32; o <<= 1) r += __shfl_xor_sync(kFull, r, o);
  return r;
}

__device__ __forceinline__ int row_of_warp(int& warp, int& lane) {
  warp = threadIdx.x >> 5;
  lane = threadIdx.x & 31;
  return blockIdx.x * (blockDim.x >> 5) + warp;
}

__host__ __device__ size_t fwd_warp_bytes(int kat) {
  return ((size_t)32 * kat + 4 * kMaxBlocks + 15) / 16 * 16;
}

__host__ __device__ size_t bwd_warp_bytes(int kat) {
  return (size_t)48 * kat + 32 * kChunk
         + ((size_t)8 * kat + 4 * kMaxBlocks + 15) / 16 * 16;
}

template <int NRS, int NTS, int ZI1>
__global__ void __launch_bounds__(kMaxWarps * 32)
angular_fwd_kernel(const float* __restrict__ planes,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   const AngParams p) {
  constexpr int NA = NRS * NTS;
  constexpr int NPAD = NA > 16 ? 32 : 16;
  static_assert(NA <= 32, "one column a lane");
  extern __shared__ float4 smem4[];
  int warp, lane;
  const int row = row_of_warp(warp, lane);
  if (row >= p.n_rows) return;
  char* base = reinterpret_cast<char*>(smem4) + warp * fwd_warp_bytes(p.kat);
  RowLanes L;
  L.q = reinterpret_cast<float4*>(base);
  L.aux = L.q + p.kat;
  L.nv = reinterpret_cast<int*>(L.aux + p.kat);
  L.cpos = nullptr;
  stage_row<false>(planes, mask, row, p, L, lane);

  float* orow = out + (size_t)row * p.n_seg * NA;
  int s = 0, base_i = 0;
  for (int bi = 0; bi < p.n_blk; ++bi) {
    const int ni = L.nv[bi];
    int base_j = base_i;
    for (int bj = bi; bj < p.n_blk; ++bj, ++s) {
      const int nj = L.nv[bj];
      float acc[NPAD];
#pragma unroll
      for (int a = 0; a < NPAD; ++a) acc[a] = 0.f;
      const bool same = bi == bj;
      const int t_end = same ? ni * (ni - 1) / 2 : ni * nj;
      SegmentWalk walk;
      walk.init(same, ni, nj, lane);
      for (int t = lane; t < t_end; t += 32) {
        const int a = base_i + walk.first(), b = base_j + walk.second();
        walk.advance(32);
        fwd_triple<NRS, NTS, ZI1, NPAD>(L.q[a], L.aux[a].x, L.q[b],
                                        L.aux[b].x, p, acc);
      }
      const float v = reduce_scatter<NPAD>(acc, lane);
      if (lane < NA) orow[s * NA + lane] = v;
      base_j += nj;
    }
    base_i += ni;
  }
}

// Cotangents of one triple's two lanes: (gj, gk) for d_j and d_k.
template <int NRS, int NTS, int ZI1>
__device__ __forceinline__ void bwd_triple(const float4& A, const float4& XA,
                                           const float4& B, const float4& XB,
                                           const float (&G)[NRS * NTS],
                                           const AngParams& p, float4& gj,
                                           float4& gk) {
  const Geometry g = geometry(A, XA.x, B, XB.x, p);
  float base[NTS], P[NTS], Q[NTS], E[NRS], U[NRS];
  bool b_ok[NTS];
#pragma unroll
  for (int ts = 0; ts < NTS; ++ts) {
    const float raw = 1.f + (g.cos_t * p.cts[ts] + g.sin_t * p.sts[ts]);
    b_ok[ts] = raw >= 1e-20f;
    base[ts] = fmaxf(raw, 1e-20f);
  }
  pow_zeta1<NTS, ZI1>(base, Q, p);
#pragma unroll
  for (int ts = 0; ts < NTS; ++ts) P[ts] = Q[ts] * base[ts];
#pragma unroll
  for (int rs = 0; rs < NRS; ++rs) {
    U[rs] = g.rm - p.rs[rs];
    E[rs] = ex2(p.neg_eta_log2e * (U[rs] * U[rs]));
  }
  // Term W = vf * E_rs * P_ts, so with cotangents G:
  //   dvf = sum G E P;  drm = vf sum G P dE/drm;  dP_ts = vf sum_rs G E.
  float c_acc[NTS];
#pragma unroll
  for (int ts = 0; ts < NTS; ++ts) c_acc[ts] = 0.f;
  float dvf = 0.f, drm_raw = 0.f;
#pragma unroll
  for (int rs = 0; rs < NRS; ++rs) {
    float p_rs = 0.f;
#pragma unroll
    for (int ts = 0; ts < NTS; ++ts) {
      const float gv = G[rs * NTS + ts];
      p_rs += gv * P[ts];
      c_acc[ts] += gv * E[rs];
    }
    const float t_rs = E[rs] * p_rs;
    dvf += t_rs;
    drm_raw += t_rs * U[rs];
  }
  const float drm = g.vf * (2.f * p.neg_eta) * drm_raw;
  float dcos = 0.f, dsin = 0.f;
#pragma unroll
  for (int ts = 0; ts < NTS; ++ts) {
    const float dctm = b_ok[ts] ? g.vf * c_acc[ts] * p.zeta * Q[ts] : 0.f;
    dcos += dctm * p.cts[ts];
    dsin += dctm * p.sts[ts];
  }
  float dr1 = 0.5f * drm + dvf * XA.y * XB.x;
  float dr2 = 0.5f * drm + dvf * XA.x * XB.y;
  float ddot;
  float c1x = 0.f, c1y = 0.f, c1z = 0.f, c2x = 0.f, c2y = 0.f, c2z = 0.f;
  if (p.torchani) {
    // sin = sqrt(1 - cos^2), cos = clip(0.95 dot / (r1 r2)).
    const float dce = g.cos_ok ? dcos - dsin * g.cos_t * g.inv_sin : 0.f;
    ddot = 0.95f * g.inv12 * dce;
    dr1 -= g.cos_t * XA.z * dce;
    dr2 -= g.cos_t * XB.z * dce;
  } else {
    // cos = clip(dot / (r1 r2)), sin = max(|d1 x d2|, 1e-6) / (r1 r2).
    const float dcm = g.cos_ok ? dcos : 0.f;
    ddot = g.inv12 * dcm;
    dr1 -= (g.cos_t * dcm + g.sin_t * dsin) * XA.z;
    dr2 -= (g.cos_t * dcm + g.sin_t * dsin) * XB.z;
    const float sc = g.c_ok ? dsin * g.inv12 * g.inv_cnorm : 0.f;
    c1x = sc * (B.y * g.cz - B.z * g.cy);
    c1y = sc * (B.z * g.cx - B.x * g.cz);
    c1z = sc * (B.x * g.cy - B.y * g.cx);
    c2x = sc * (g.cy * A.z - g.cz * A.y);
    c2y = sc * (g.cz * A.x - g.cx * A.z);
    c2z = sc * (g.cx * A.y - g.cy * A.x);
  }
  const float s1 = dr1 * XA.w, s2 = dr2 * XB.w;
  gj = make_float4(ddot * B.x + s1 * A.x + c1x, ddot * B.y + s1 * A.y + c1y,
                   ddot * B.z + s1 * A.z + c1z, 0.f);
  gk = make_float4(ddot * A.x + s2 * B.x + c2x, ddot * A.y + s2 * B.y + c2y,
                   ddot * A.z + s2 * B.z + c2z, 0.f);
}

__device__ __forceinline__ void add3(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
}

template <int NRS, int NTS, int ZI1>
__global__ void __launch_bounds__(kMaxWarps * 32)
angular_bwd_kernel(const float* __restrict__ planes,
                   const uint8_t* __restrict__ mask,
                   const int* __restrict__ col_lane,
                   const float* __restrict__ g, float* __restrict__ out,
                   const AngParams p) {
  constexpr int NA = NRS * NTS;
  static_assert(NA <= 32, "one cotangent a lane");
  extern __shared__ float4 smem4[];
  int warp, lane;
  const int row = row_of_warp(warp, lane);
  if (row >= p.n_rows) return;
  float4* base = reinterpret_cast<float4*>(
      reinterpret_cast<char*>(smem4) + warp * bwd_warp_bytes(p.kat));
  RowLanes L;
  L.q = base;
  L.aux = L.q + p.kat;
  float4* acc = L.aux + p.kat;     // [kat] owner-only sums (x, y, z)
  float4* buf_j = acc + p.kat;     // [kChunk] j-side cotangents
  float4* buf_k = buf_j + kChunk;  // [kChunk] k-side cotangents
  int* cur = reinterpret_cast<int*>(buf_k + kChunk);   // [kat]
  L.cpos = cur + p.kat;            // [kat]
  L.nv = L.cpos + p.kat;
  const int nv = stage_row<true>(planes, mask, row, p, L, lane);
  for (int c = lane; c < nv; c += 32) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float* grow = g + (size_t)row * p.n_seg * NA;
  int s = 0, base_i = 0;
  for (int bi = 0; bi < p.n_blk; ++bi) {
    const int ni = L.nv[bi];
    int base_j = base_i;
    for (int bj = bi; bj < p.n_blk; ++bj, ++s) {
      const int nj = L.nv[bj];
      const bool same = bi == bj;
      const int t_end = same ? ni * (ni - 1) / 2 : ni * nj;
      if (t_end > 0) {
        float G[NA];
        const float gl = lane < NA ? grow[s * NA + lane] : 0.f;
#pragma unroll
        for (int a = 0; a < NA; ++a) G[a] = __shfl_sync(kFull, gl, a);
        if (same)
          for (int c = lane; c < nv; c += 32) cur[c] = 0;
        SegmentWalk walk;
        walk.init(same, ni, nj, lane);
        for (int lo = 0; lo < t_end; lo += kChunk) {
          const int hi = min(t_end, lo + kChunk);
          // Each triple's two cotangents at its position in the chunk.
          for (int t = lo + lane; t < hi; t += 32) {
            const int a = base_i + walk.first(), b = base_j + walk.second();
            walk.advance(32);
            bwd_triple<NRS, NTS, ZI1>(L.q[a], L.aux[a], L.q[b], L.aux[b], G,
                                      p, buf_j[t - lo], buf_k[t - lo]);
          }
          __syncwarp();
          // Each owned lane adds its entries of the chunk, ascending.
          for (int c = lane; c < nv; c += 32) {
            float4 sum = acc[c];
            if (c >= base_i && c < base_i + ni) {
              const int a = c - base_i;
              int f0, f1;   // its entries as the first lane: [f0, f1)
              if (same) {
                // As the second lane (a' < a): before row a, by cursor.
                int ap = cur[c];
                for (; ap < a; ++ap) {
                  const int t = tri_row_start(ap, ni) + a - ap - 1;
                  if (t >= hi) break;
                  add3(sum, buf_k[t - lo]);
                }
                cur[c] = ap;
                f0 = tri_row_start(a, ni);
                f1 = f0 + ni - 1 - a;
              } else {
                f0 = a * nj;
                f1 = f0 + nj;
              }
              for (int t = max(f0, lo); t < min(f1, hi); ++t)
                add3(sum, buf_j[t - lo]);
            } else if (!same && c >= base_j && c < base_j + nj) {
              // As the second lane of the rectangle: column b.
              const int b = c - base_j;
              for (int ap = lo > b ? (lo - b + nj - 1) / nj : 0; ap < ni;
                   ++ap) {
                const int t = b + ap * nj;
                if (t >= hi) break;
                add3(sum, buf_k[t - lo]);
              }
            }
            acc[c] = sum;
          }
          __syncwarp();
        }
      }
      base_j += nj;
    }
    base_i += ni;
  }
  __syncwarp();
  // Every column of the row is written once: the lane's cotangent where an
  // angular lane sits (zero if it is not valid), zero elsewhere
  // (radial-only lanes).
  const size_t plane = (size_t)p.n_rows * p.width;
  for (int col = lane; col < p.width; col += 32) {
    const int l = col_lane[col];
    const int c = l >= 0 ? L.cpos[l] : -1;
    const float4 v = c >= 0 ? acc[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t at = (size_t)row * p.width + col;
    out[at] = v.x;
    out[plane + at] = v.y;
    out[2 * plane + at] = v.z;
  }
}

// Returns 0, or a cudaError_t for arguments the kernel does not take.
int make_params(AngParams* p, int n_rows, int width, int kat, int n_blk,
                const int* blk_caps, const int* blk_pos, int n_rs, int n_ts,
                const float* rs, const float* cts, const float* sts,
                double ra, double eta, double zeta, int torchani) {
  if (n_blk < 1 || n_blk > kMaxBlocks || n_rs > kMaxGrid || n_ts > kMaxGrid
      || !(zeta >= 1.0) || zeta >= (1 << kZetaBits) + 1.0)
    return (int)cudaErrorInvalidValue;
  p->n_rows = n_rows;
  p->width = width;
  p->kat = kat;
  p->n_blk = n_blk;
  p->n_seg = n_blk * (n_blk + 1) / 2;
  int total = 0;
  for (int b = 0; b < kMaxBlocks; ++b) {
    p->blk_cap[b] = b < n_blk ? blk_caps[b] : 0;
    p->blk_pos[b] = b < n_blk ? blk_pos[b] : 0;
    if (b < n_blk && (blk_pos[b] < 0 || blk_pos[b] + blk_caps[b] > width))
      return (int)cudaErrorInvalidValue;
    total += p->blk_cap[b];
  }
  if (total != kat) return (int)cudaErrorInvalidValue;
  // Derived constants in double, rounded once to f32 (the reference's
  // Python-float constants).
  p->ra = (float)ra;
  p->far = (float)(4.0 * ra);
  p->inv_ra2 = (float)(1.0 / (ra * ra));
  p->two_inv_ra2 = (float)(2.0 * (1.0 / (ra * ra)));
  p->neg_eta = (float)(-eta);
  p->neg_eta_log2e = (float)(-eta * 1.4426950408889634);
  p->zeta = (float)zeta;
  const int zi = (int)std::floor(zeta);
  p->zi1 = zi - 1;
  p->zf = (zeta - zi) > 1e-12 ? (float)(zeta - zi) : 0.f;
  p->torchani = torchani;
  for (int i = 0; i < kMaxGrid; ++i) {
    p->rs[i] = i < n_rs ? rs[i] : 0.f;
    p->cts[i] = i < n_ts ? cts[i] : 0.f;
    p->sts[i] = i < n_ts ? sts[i] : 0.f;
  }
  return 0;
}

// Warps a block: the most (up to kMaxWarps) that still leave kMinBlocks
// blocks, and whose shared memory fits.
int warps_per_block(int n_rows, size_t warp_bytes) {
  int wpb = kMaxWarps;
  while (wpb > 1 && ((n_rows + wpb - 1) / wpb < kMinBlocks
                     || wpb * warp_bytes > 232448))
    wpb >>= 1;
  return wpb;
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

template <int NRS, int NTS, int ZI1>
int launch_fwd(const float* planes, const uint8_t* mask, float* out,
               const AngParams& p, cudaStream_t stream) {
  const size_t wb = fwd_warp_bytes(p.kat);
  const int wpb = warps_per_block(p.n_rows, wb);
  const size_t smem = wpb * wb;
  cudaError_t err = prepare(angular_fwd_kernel<NRS, NTS, ZI1>, smem);
  if (err != cudaSuccess) return (int)err;
  angular_fwd_kernel<NRS, NTS, ZI1>
      <<<(p.n_rows + wpb - 1) / wpb, wpb * 32, smem, stream>>>(planes, mask,
                                                               out, p);
  return (int)cudaGetLastError();
}

template <int NRS, int NTS, int ZI1>
int launch_bwd(const float* planes, const uint8_t* mask, const int* col_lane,
               const float* g, float* out, const AngParams& p,
               cudaStream_t stream) {
  const size_t wb = bwd_warp_bytes(p.kat);
  const int wpb = warps_per_block(p.n_rows, wb);
  const size_t smem = wpb * wb;
  cudaError_t err = prepare(angular_bwd_kernel<NRS, NTS, ZI1>, smem);
  if (err != cudaSuccess) return (int)err;
  angular_bwd_kernel<NRS, NTS, ZI1>
      <<<(p.n_rows + wpb - 1) / wpb, wpb * 32, smem, stream>>>(
          planes, mask, col_lane, g, out, p);
  return (int)cudaGetLastError();
}

template <int NRS, int NTS>
int dispatch_fwd(const float* planes, const uint8_t* mask, float* out,
                 const AngParams& p, cudaStream_t st) {
  if (p.zi1 == kAniZi1)
    return launch_fwd<NRS, NTS, kAniZi1>(planes, mask, out, p, st);
  return launch_fwd<NRS, NTS, -1>(planes, mask, out, p, st);
}

template <int NRS, int NTS>
int dispatch_bwd(const float* planes, const uint8_t* mask,
                 const int* col_lane, const float* g, float* out,
                 const AngParams& p, cudaStream_t st) {
  if (p.zi1 == kAniZi1)
    return launch_bwd<NRS, NTS, kAniZi1>(planes, mask, col_lane, g, out, p,
                                         st);
  return launch_bwd<NRS, NTS, -1>(planes, mask, col_lane, g, out, p, st);
}

}  // namespace

extern "C" {

const char* nnpops_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int angular_aev_fwd(const float* planes, const uint8_t* mask, float* out,
                    int n_rows, int width, int kat, int n_blk,
                    const int* blk_caps, const int* blk_pos, int n_rs,
                    int n_ts, const float* rs, const float* cts,
                    const float* sts, double ra, double eta, double zeta,
                    int torchani, void* stream) {
  if (n_rows <= 0) return 0;
  AngParams p;
  const int bad = make_params(&p, n_rows, width, kat, n_blk, blk_caps,
                              blk_pos, n_rs, n_ts, rs, cts, sts, ra, eta,
                              zeta, torchani);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rs == 8 && n_ts == 4)
    return dispatch_fwd<8, 4>(planes, mask, out, p, st);
  if (n_rs == 3 && n_ts == 3)
    return dispatch_fwd<3, 3>(planes, mask, out, p, st);
  return (int)cudaErrorInvalidValue;
}

int angular_aev_bwd(const float* planes, const uint8_t* mask,
                    const int* col_lane, const float* g, float* out,
                    int n_rows, int width, int kat, int n_blk,
                    const int* blk_caps, const int* blk_pos, int n_rs,
                    int n_ts, const float* rs, const float* cts,
                    const float* sts, double ra, double eta, double zeta,
                    int torchani, void* stream) {
  if (n_rows <= 0) return 0;
  AngParams p;
  const int bad = make_params(&p, n_rows, width, kat, n_blk, blk_caps,
                              blk_pos, n_rs, n_ts, rs, cts, sts, ra, eta,
                              zeta, torchani);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rs == 8 && n_ts == 4)
    return dispatch_bwd<8, 4>(planes, mask, col_lane, g, out, p, st);
  if (n_rs == 3 && n_ts == 3)
    return dispatch_bwd<3, 3>(planes, mask, col_lane, g, out, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
