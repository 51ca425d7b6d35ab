// RWKV6 (Finch) WKV scan for Hopper (sm_90a): bf16 r/k/v with the products
// on the tensor cores, or fp32 r/k/v on the CUDA cores; fp32 w and u, fp32
// state, output in r's dtype.
//
// Replaces the TPU kernel repro/kernels/wkv6_scan.py:_kernel (called by
// wkv6_scan() there).  Per (b, h), with lw = log(clip(w, 1e-12, 1)), the
// exclusive / inclusive cumsums ecl / cl of lw over a chunk of time, and a
// (D, D) fp32 state S carried from chunk to chunk:
//   att[t,s] = sum_d r[t,d] exp(ecl[t,d] - cl[s,d]) k[s,d]      (s < t)
//   att[t,t] = sum_d r[t,d] u[d] k[t,d]                          (the bonus)
//   y[t,:]   = att[t,:] . v + (r[t,:] * exp(ecl[t,:])) . S
//   S       <- diag(exp(cl[L-1,:])) S + (k * exp(cl[L-1,:] - cl))^T v
// Every exponent is <= 0 (lw <= 0 and cl is non-increasing), so nothing
// overflows and nothing is clamped: rwkv6-3b's decays reach the clip at
// log 1e-12 = -27.6 a step, where a form factored through a reference point
// would need clamps and would no longer equal this one.  Layout: r, k, v,
// w, y (B,S,H,D), u (H,D), contiguous.
//
// Design.  The Pallas grid (B, H, S/chunk) ran its chunk axis in order on
// one core, carrying S in VMEM.  Blocks of a GPU run in no order, so a
// block walks time itself:
//   * Chunks of 16 rows ("sub-tiles"), the state carried through them.
//     Chunking is exact, so the result equals the chunked algorithm
//     (ref.wkv6_chunked_ref) at any `chunk`; the wrapper's `chunk` only pads
//     S, and a ragged last sub-tile is cut to the rows that exist (its
//     missing rows are given lw = 0 and zero r/k/v).  The pairwise part
//     shrinks to 7.5 (t, s) pairs a row instead of 31.5 at 64 rows; the rest
//     are products of fixed shape per sub-tile:
//       y     = [att | r exp(ecl)] (16 x (16+D)) . [v ; S] ((16+D) x E)
//       S     = diag(exp(cl_last)) S + (k exp(cl_last - cl))^T (D x 16) . v
//   * The state's columns are split across blocks: a block owns (b, h, E of
//     the D value columns), E = min(D, 32), so rwkv6-3b's B*H = 160 heads
//     make 320 blocks of 4 warps and ~48 KB, all resident in one wave.
//     Each block recomputes its sub-tile's 16 x 16 att; its 136 pairs
//     s <= t are packed densely over the lane groups, so every warp does
//     the same number of exponentials.
//   * bf16: the products run on mma.sync.m16n8k16 with bf16 operands and
//     fp32 accumulators (tc_ptx.cuh).  The state lives in registers as the
//     accumulator fragments of the update (warp w owns rows 16w..16w+15 of
//     S) and is decayed and summed there in fp32; a copy in shared memory
//     is the B operand of the next sub-tile's y.  Every fp32 operand (att,
//     r exp(ecl), k exp(cl_last - cl) and that copy of S) is split into
//     hi = bf16(x) and lo = bf16(x - hi), and a product is taken as
//     a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (v is bf16 already): about 16
//     mantissa bits, so the operands keep the Pallas body's fp32 to within
//     ~2^-17, at 2-3 mma for each one.  Plain bf16 operands (what the
//     reference's blocked form does, ref.py:321, :343) moved rwkv6-3b's
//     served logits past the spread of its own plain versions; the split
//     keeps the kernel at the Pallas body's numerics.
//     ref.wkv6_subtile_ref mirrors every rounding point.
//   * fp32 (dtype 0): the same algorithm with scalar fp32 FMAs from shared
//     memory, the state in shared memory.
//   * The log and clip of w are fused (no lw array in device memory); the
//     cumsums are kept in log2 units, so each exponential is one ex2.  The
//     next sub-tile's r, k, v, w are copied with 16-byte cp.async while
//     this one computes.
//
// What bounds it on an H100.  At rwkv6-3b's prefill (B=4, S=512, H=40,
// D=64) the bytes (r, k, v, y in bf16, w in fp32: 63 MB, each once) need
// 19 us at 3.35 TB/s, and the products are far below the tensor cores'
// rate.  Per sub-tile a block does 16 x 64 logs, 136 x 64 exponentials
// for att (in both blocks of a head), 2 x 16 x 64 for the factors, ~22 mma
// a warp and 4 barriers; with 32 sub-tiles in sequence a block, the kernel
// is bound by the latency of the two exponential phases, hidden only by
// the 2-3 blocks an SM holds (about 11x the bytes bound on an H100).
// Later work: fewer exponentials (the cross block of a sub-tile factors
// through its midpoint with both exponents <= 0, no clamps), more warps
// an SM, TMA loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc_ptx.cuh"

namespace {

constexpr int LS = 16;   // time rows per sub-tile
constexpr int NT = 128;  // threads per block: 4 warps

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// N consecutive values from shared memory, 16-byte aligned where N allows.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  static_assert(N % 2 == 0, "even runs");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = x.x, o[4 * i + 1] = x.y, o[4 * i + 2] = x.z, o[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(p)[i];
      o[2 * i] = x.x, o[2 * i + 1] = x.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[N]) {
  static_assert(N % 2 == 0, "even runs");
  uint32_t w[N / 2];
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x, w[4 * i + 1] = x.y, w[4 * i + 2] = x.z, w[4 * i + 3] = x.w;
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = x.x, w[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x, o[2 * i + 1] = f.y;
  }
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* y;
  int B, S, H;
};

// Shared memory of one block, in bytes from the start; every piece is a
// multiple of 16 bytes.  Rows read by ldmatrix are padded by 8 elements.
template <typename T, int D, int E>
struct Smem {
  static constexpr int DP = D + 8;   // r exp(ecl), k exp(cl_last - cl) rows
  static constexpr int VL = E + 8;   // v and state rows
  static constexpr int AL = LS + 8;  // att rows
  // one stage of the prefetched inputs: r, k (LS x D), v (LS x VL), w
  static constexpr int R = 0;
  static constexpr int K = R + LS * D * sizeof(T);
  static constexpr int V = K + LS * D * sizeof(T);
  static constexpr int W = V + LS * VL * sizeof(T);
  static constexpr int STAGE = W + LS * D * sizeof(float);
  // working set
  static constexpr int ECL = 2 * STAGE;
  static constexpr int CL = ECL + LS * D * sizeof(float);
  static constexpr int DEC = CL + LS * D * sizeof(float);
  static constexpr int U = DEC + D * sizeof(float);
  static constexpr int ATT = U + D * sizeof(float);
  static constexpr int REXP = ATT + LS * AL * sizeof(T);
  static constexpr int KTAIL = REXP + LS * DP * sizeof(T);
  static constexpr int ST = KTAIL + LS * DP * sizeof(T);
  // bf16: the low halves of the split operands (x - bf16(x), in bf16)
  static constexpr int LO = std::is_same<T, float>::value ? 0 : 1;
  static constexpr int ATT_LO = ST + D * VL * sizeof(T);
  static constexpr int REXP_LO = ATT_LO + LO * LS * AL * sizeof(T);
  static constexpr int KTAIL_LO = REXP_LO + LO * LS * DP * sizeof(T);
  static constexpr int ST_LO = KTAIL_LO + LO * LS * DP * sizeof(T);
  static constexpr int BYTES = ST_LO + LO * D * VL * sizeof(T);
};

// x as hi + lo, both in T: for bf16 hi = bf16(x) and lo = bf16(x - hi),
// together good to about 16 bits of mantissa; for fp32 hi = x and no lo.
template <typename T>
__device__ __forceinline__ void split_store(T* hi, T* lo, int i, float x) {
  hi[i] = from_f32<T>(x);
  if constexpr (!std::is_same<T, float>::value)
    lo[i] = from_f32<T>(x - to_f32(hi[i]));
}

// S entries (x0, x1) of one fragment row as split bf16 pairs
__device__ __forceinline__ void split_store2(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, int i,
                                             float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi + i) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + i) =
      __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
}

template <typename T, int D, int E>
__global__ void __launch_bounds__(NT) wkv6_kernel(const Params p) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  using M = Smem<T, D, E>;
  constexpr int DP = M::DP, VL = M::VL, AL = M::AL;
  constexpr int DC = D / 8;  // channels per thread in the att phase
  static_assert(D % 16 == 0 && E % 16 == 0 && D % E == 0, "tile shapes");
  static_assert(2 * D <= NT, "phase 1 runs 2 threads a channel");
  extern __shared__ __align__(16) unsigned char smem[];
  float* ecl = reinterpret_cast<float*>(smem + M::ECL);  // LS x D
  float* cl = reinterpret_cast<float*>(smem + M::CL);    // LS x D
  float* dec = reinterpret_cast<float*>(smem + M::DEC);  // exp(cl_last)
  float* us = reinterpret_cast<float*>(smem + M::U);
  T* att = reinterpret_cast<T*>(smem + M::ATT);      // LS x AL
  T* rexp = reinterpret_cast<T*>(smem + M::REXP);    // LS x DP
  T* ktail = reinterpret_cast<T*>(smem + M::KTAIL);  // LS x DP
  T* st = reinterpret_cast<T*>(smem + M::ST);        // D x VL: S (bf16 copy)
  T* att_lo = reinterpret_cast<T*>(smem + M::ATT_LO);      // bf16 only
  T* rexp_lo = reinterpret_cast<T*>(smem + M::REXP_LO);
  T* ktail_lo = reinterpret_cast<T*>(smem + M::KTAIL_LO);
  T* st_lo = reinterpret_cast<T*>(smem + M::ST_LO);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int e0 = blockIdx.x * E;  // this block's value columns
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row = (long long)p.H * D;  // stride of s
  const long long base = (long long)b * p.S * row + (long long)h * D;
  const T* rg = static_cast<const T*>(p.r) + base;
  const T* kg = static_cast<const T*>(p.k) + base;
  const T* vg = static_cast<const T*>(p.v) + base + e0;
  const float* wg = p.w + base;
  T* yg = static_cast<T*>(p.y) + base + e0;

  for (int i = tid; i < D; i += NT) us[i] = p.u[h * D + i];
  for (int i = tid; i < D * VL; i += NT) split_store(st, st_lo, i, 0.f);
  for (int i = tid; i < LS * AL; i += NT) split_store(att, att_lo, i, 0.f);
  // bf16: S rows 16*warp + g (+8), columns 8j + 2q4 (+1), as mma fragments
  float sacc[E / 8][4];
#pragma unroll
  for (int j = 0; j < E / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) sacc[j][c] = 0.f;

  // rows [t0, t0 + LS) of r, k, v (this block's columns) and w into a
  // stage; rows past S are zero-filled
  auto prefetch = [&](int t0, int stage) {
    unsigned char* sb = smem + stage * M::STAGE;
    constexpr int CD = D * sizeof(T) / 16;  // 16-byte chunks of an r/k row
    constexpr int CV = E * sizeof(T) / 16;
    constexpr int CW = D * sizeof(float) / 16;
    for (int i = tid; i < LS * CD; i += NT) {
      const int t = i / CD, c = i % CD;
      const bool in = t0 + t < p.S;
      const long long off = (in ? t0 + t : 0) * row;
      tc::cp_async16(sb + M::R + t * D * sizeof(T) + 16 * c,
                     reinterpret_cast<const unsigned char*>(rg + off) + 16 * c, in);
      tc::cp_async16(sb + M::K + t * D * sizeof(T) + 16 * c,
                     reinterpret_cast<const unsigned char*>(kg + off) + 16 * c, in);
    }
    for (int i = tid; i < LS * CV; i += NT) {
      const int t = i / CV, c = i % CV;
      const bool in = t0 + t < p.S;
      const long long off = (in ? t0 + t : 0) * row;
      tc::cp_async16(sb + M::V + t * VL * sizeof(T) + 16 * c,
                     reinterpret_cast<const unsigned char*>(vg + off) + 16 * c, in);
    }
    for (int i = tid; i < LS * CW; i += NT) {
      const int t = i / CW, c = i % CW;
      const bool in = t0 + t < p.S;
      const long long off = (in ? t0 + t : 0) * row;
      tc::cp_async16(sb + M::W + t * D * sizeof(float) + 16 * c,
                     reinterpret_cast<const unsigned char*>(wg + off) + 16 * c, in);
    }
    tc::cp_async_commit();
  };

  // The LS (LS + 1) / 2 pairs s <= t of att, packed densely so that every
  // warp does the same number of exponentials: lane group tid / 8 takes
  // pairs tid / 8, tid / 8 + NG, ... (row-major over t), the same in every
  // sub-tile; lane dc of the group sums channels [dc*DC, dc*DC + DC).
  // The pairs s > t stay zero from the start.
  constexpr int NG = NT / 8;
  constexpr int NIT = (LS * (LS + 1) / 2 + NG - 1) / NG;
  const int dc = tid % 8, d0 = dc * DC;
  int pt[NIT], ps[NIT];
  {
    int t = 0, s = tid / 8;
#pragma unroll
    for (int i = 0; i < NIT; ++i, s += NG) {
      while (s > t) s -= ++t;
      pt[i] = t;
      ps[i] = s;
    }
  }
  __syncthreads();  // u, S and att initialised
  float ur[DC];
  lds<DC>(us + d0, ur);

  const int nsub = (p.S + LS - 1) / LS;
  prefetch(0, 0);
  for (int i = 0; i < nsub; ++i) {
    const int t0 = i * LS;
    const int n = min(LS, p.S - t0);  // rows in this sub-tile
    const unsigned char* sb = smem + (i & 1) * M::STAGE;
    const T* rs = reinterpret_cast<const T*>(sb + M::R);     // LS x D
    const T* ks = reinterpret_cast<const T*>(sb + M::K);     // LS x D
    const T* vs = reinterpret_cast<const T*>(sb + M::V);     // LS x VL
    const float* ws = reinterpret_cast<const float*>(sb + M::W);
    tc::cp_async_wait_all();
    __syncthreads();  // sub-tile i landed; all of sub-tile i - 1 is done
    if (i + 1 < nsub) prefetch(t0 + LS, (i + 1) & 1);

    // 1. per channel: log2 and clip, cumsums and the two decayed factors.
    //    The cumsums are kept in log2 units, so every exponential of the
    //    sub-tile is one ex2.  Two threads a channel, each writing half of
    //    the results.
    if (tid < 2 * D) {
      const int d = tid % D, half = tid / D;
      float e_r[LS], c_r[LS], c = 0.f;
#pragma unroll
      for (int t = 0; t < LS; ++t) {
        const float lw =
            t < n ? __log2f(fminf(fmaxf(ws[t * D + d], 1e-12f), 1.f)) : 0.f;
        e_r[t] = c;
        c += lw;
        c_r[t] = c;
      }
      if (half == 0) {
#pragma unroll
        for (int t = 0; t < LS; ++t) {
          ecl[t * D + d] = e_r[t];
          cl[t * D + d] = c_r[t];
          split_store(rexp, rexp_lo, t * DP + d,
                      to_f32(rs[t * D + d]) * exp2f(e_r[t]));
        }
      } else {
        dec[d] = exp2f(c);
#pragma unroll
        for (int t = 0; t < LS; ++t)
          split_store(ktail, ktail_lo, t * DP + d,
                      to_f32(ks[t * D + d]) * exp2f(c - c_r[t]));
      }
    }
    __syncthreads();

    // 2. att over the pairs s <= t (see pt/ps): each lane sums its
    //    channels of its group's pairs, then the group meets by shuffles.
    {
      float a[NIT];
#pragma unroll
      for (int i = 0; i < NIT; ++i) {
        const int t = pt[i], s = ps[i];
        a[i] = 0.f;
        if (t >= LS) continue;  // past the last pair
        float rr[DC], kk[DC];
        lds<DC>(rs + t * D + d0, rr);
        lds<DC>(ks + s * D + d0, kk);
        if (s < t) {
          float er[DC], cc[DC];
          lds<DC>(ecl + t * D + d0, er);
          lds<DC>(cl + s * D + d0, cc);
#pragma unroll
          for (int j = 0; j < DC; ++j)
            a[i] = fmaf(rr[j] * exp2f(er[j] - cc[j]), kk[j], a[i]);
        } else {
#pragma unroll
          for (int j = 0; j < DC; ++j) a[i] = fmaf(rr[j] * ur[j], kk[j], a[i]);
        }
      }
#pragma unroll
      for (int m = 1; m < 8; m *= 2)
#pragma unroll
        for (int i = 0; i < NIT; ++i)
          a[i] += __shfl_xor_sync(0xffffffffu, a[i], m);
#pragma unroll
      for (int i = 0; i < NIT; ++i)  // lane i % 8 of the group stores pair i
        if (dc == i % 8 && pt[i] < LS)
          split_store(att, att_lo, pt[i] * AL + ps[i], a[i]);
    }
    __syncthreads();

    // 3. y = att . v + rexp . S, and (bf16) the state update in registers
    if constexpr (TC) {
      if (warp < E / 8) {  // warp w: y columns 8w..8w+7 of the slice
        const int ec = 8 * warp;
        // split products: a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (v is
        // bf16 already, so it has no low half)
        float acc[4] = {0.f, 0.f, 0.f, 0.f};   // the hi.hi products
        float acl[4] = {0.f, 0.f, 0.f, 0.f};   // the products with a lo half
        uint32_t a[4], bf[2], bl[2];
        tc::ldsm_x2_trans(bf, vs + (lane % 16) * VL + ec);
        tc::ldsm_x4(a, att_lo + (lane % 16) * AL + (lane / 16) * 8);
        tc::mma_bf16(acl, a, bf[0], bf[1]);
        tc::ldsm_x4(a, att + (lane % 16) * AL + (lane / 16) * 8);
        tc::mma_bf16(acc, a, bf[0], bf[1]);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int arow = (lane % 16) * DP + kk * 16 + (lane / 16) * 8;
          const int brow = (kk * 16 + lane % 16) * VL + ec;
          tc::ldsm_x2_trans(bf, st + brow);
          tc::ldsm_x2_trans(bl, st_lo + brow);
          tc::ldsm_x4(a, rexp_lo + arow);
          tc::mma_bf16(acl, a, bf[0], bf[1]);
          tc::ldsm_x4(a, rexp + arow);
          tc::mma_bf16(acl, a, bl[0], bl[1]);
          tc::mma_bf16(acc, a, bf[0], bf[1]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += acl[c];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = g + 8 * hh;
          if (t < n)
            *reinterpret_cast<uint32_t*>(yg + (t0 + t) * row + ec + 2 * q4) =
                tc::pack_bf16(acc[2 * hh], acc[2 * hh + 1]);
        }
      }
      if (warp < D / 16) {  // warp w: state rows 16w..16w+15
        const int dm = 16 * warp;
        const float d_lo = dec[dm + g], d_hi = dec[dm + g + 8];
        // (k exp(cl_last - cl))^T, rows d and k = time, as hi and lo
        const int arow = (lane % 8 + (lane / 16) * 8) * DP + dm +
                         ((lane / 8) % 2) * 8;
        uint32_t a[4], al[4];
        tc::ldsm_x4_trans(a, ktail + arow);
        tc::ldsm_x4_trans(al, ktail_lo + arow);
#pragma unroll
        for (int j = 0; j < E / 8; j += 2) {
          uint32_t bf[4];
          tc::ldsm_x4_trans(bf, vs + (lane % 16) * VL + 8 * j + (lane / 16) * 8);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            sacc[j + jj][0] *= d_lo;
            sacc[j + jj][1] *= d_lo;
            sacc[j + jj][2] *= d_hi;
            sacc[j + jj][3] *= d_hi;
          }
          tc::mma_bf16(sacc[j], al, bf[0], bf[1]);
          tc::mma_bf16(sacc[j + 1], al, bf[2], bf[3]);
          tc::mma_bf16(sacc[j], a, bf[0], bf[1]);
          tc::mma_bf16(sacc[j + 1], a, bf[2], bf[3]);
        }
      }
    } else {
      for (int o = tid; o < LS * E; o += NT) {
        const int t = o / E, e = o % E;
        if (t >= n) continue;
        float acc = 0.f;
        for (int s = 0; s <= t; ++s)
          acc = fmaf(to_f32(att[t * AL + s]), to_f32(vs[s * VL + e]), acc);
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          acc = fmaf(to_f32(rexp[t * DP + d]), to_f32(st[d * VL + e]), acc);
        yg[(t0 + t) * row + e] = from_f32<T>(acc);
      }
    }
    __syncthreads();  // every read of the state copy is done

    // 4. the state for the next sub-tile
    if constexpr (TC) {
      if (warp < D / 16) {
        const int dm = 16 * warp;
#pragma unroll
        for (int j = 0; j < E / 8; ++j) {
          split_store2(st, st_lo, (dm + g) * VL + 8 * j + 2 * q4, sacc[j][0],
                       sacc[j][1]);
          split_store2(st, st_lo, (dm + g + 8) * VL + 8 * j + 2 * q4,
                       sacc[j][2], sacc[j][3]);
        }
      }
    } else {
      for (int o = tid; o < D * E; o += NT) {
        const int d = o / E, e = o % E;
        float acc = to_f32(st[d * VL + e]) * dec[d];
#pragma unroll
        for (int s = 0; s < LS; ++s)
          acc = fmaf(to_f32(ktail[s * DP + d]), to_f32(vs[s * VL + e]), acc);
        st[d * VL + e] = from_f32<T>(acc);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int E = D < 32 ? D : 32;
  constexpr size_t smem = Smem<T, D, E>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(D / E, p.H, p.B);
  wkv6_kernel<T, D, E><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success).  The caller has
// checked shapes, dtypes and contiguity; dtype 0 is float32, 1 is bfloat16
// (of r, k, v and y; w and u are float32).  The kernel copies 16-byte
// chunks, so r, k, v, w and y must be 16-byte aligned
// (cudaErrorMisalignedAddress otherwise).
extern "C" int wkv6_scan_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, void* y, int B,
                             int S, int H, int D, int dtype, void* stream) {
  Params p{r, k, v, static_cast<const float*>(w),
           static_cast<const float*>(u), y, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
        aligned16(y)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(p, D, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(p, D, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* wkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
