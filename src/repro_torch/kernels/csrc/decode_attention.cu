// Decode attention for Hopper (sm_90a): one query token a row against a
// (B, T, KV, D) key / value cache, read as stored (bf16 or fp32) and each
// element once; q and the output bf16 or fp32; every product, sum and
// softmax weight in fp32.
//
// Replaces no TPU kernel.  The JAX package's decode attention
// (repro/kernels/ops.py:decode_attention) is the plain function
// ref.decode_attention_ref, and so was the port's: it casts the whole cache
// to fp32 and runs two batched matrix-vector products, so each step writes
// an fp32 copy of the cache, reads it again, and permutes it, over four
// times the cache's bytes.  This kernel streams the cache as it lies and
// writes no copy of it.
//
// What bounds it on an H100.  One token against T positions does 4 D FLOPs
// a (query head, position) over the 2 D cache elements of the position's
// KV head: at g = H / KV query heads a KV head about g FLOPs a byte of a
// bf16 cache, far below the ~295 where the tensor cores would bound it.
// The cache's bytes, read once, bound it: zamba2-1.2b decoding 128 rows
// (H = KV = 32, D = 128, T = 4096) reads 2 x 128 x 4096 x 32 x 128 x 2 bytes
// = 8.6 GB an application, 2.56 ms at 3.35 TB/s.
//
// Design.
//   * Grid: one block a (row b, KV head, group of query heads, split of the
//     positions).  The block loads its group's G query heads once (fp32, in
//     shared memory; in registers where they fit) and attends all of them
//     over its positions, so K and V are read once for the g query heads of
//     a KV head.  G is the smallest instance >= g, at most 16; a wider group
//     is cut into groups of 16, each reading the cache again.
//   * Each of the block's warps streams its own tiles of 16 positions
//     (tiles w, w + WARPS, ...) through its own ring of NS stages in shared
//     memory with 16-byte cp.async: rows of D elements, coalesced; NS - 1
//     tiles in flight a warp while it computes on the oldest, and only
//     __syncwarp between a warp's stages.  A K row is padded so that the
//     16-byte reads of a quarter-warp fall in distinct banks.
//   * q . k: two lanes a position, each half the row's chunks, joined by
//     one shuffle; then the scale, the softcap (tanh) where given, and the
//     tile's rows past the block's positions dropped.  An online softmax a
//     query head (the warp's running max m and sum l); the tile's weights p
//     go to shared memory in fp32 (never rounded) and p . v runs with each
//     lane owning D / 32 output columns: o = o exp(m - m') + sum_t p_t v_t.
//   * At the end the warps' (m, l, o) are joined in shared memory.  With one
//     split the block writes o / l in q's dtype; with several it writes its
//     (o, m, l) as fp32 partials and decode_attn_merge_kernel joins the
//     splits.  The wrapper splits the positions only where B x KV blocks
//     would not fill two waves of the SMs (small-batch serving).
//   * Only the attended positions [lo, hi) are loaded.
//
// Layout: q and out (B, 1, H, D) contiguous; the cache with strides (sb,
// st, D, 1) in elements (a contiguous cache, or one sliced along its KV
// heads), 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_ptx.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
// shared memory the warps' rings may take together: three stages at D 128
// in bf16 (104 KB), so that two blocks fit an SM
constexpr int RING_BUDGET = 110000;
constexpr int P = 16;    // positions a warp-tile
constexpr int LPP = 2;   // lanes a position in q . k
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;    // (B, 1, H, D)
  const void* k;    // (B, T, KV, D), strides (sb, st, D, 1)
  const void* v;
  void* out;        // (B, 1, H, D), q's dtype
  float* part_o;    // (B, H, splits, D): unnormalised outputs of the splits
  float* part_ml;   // (B, H, splits, 2): their max and sum
  long long sb, st;
  int H, KV, g, lo, hi, chunk, splits, head_groups;
  float scale, softcap;
  int q_bf16;
};

// Sizes of an instance: TC the cache's element type, D the head size, G the
// query heads a block.  Shared memory (bytes): the warps' rings, [0, RING)
// (at the end the warps' partial rows, COMBINE bytes, reuse it), q as fp32
// at Q_OFF, the warps' tile weights at P_OFF.
template <typename TC, int D, int G>
struct Cfg {
  static constexpr int E = 16 / static_cast<int>(sizeof(TC));  // a chunk
  static constexpr int C = D / E;      // 16-byte chunks a row (E elements)
  static constexpr int QC = C / LPP;   // chunks a lane reads in q . k
  // K row stride in chunks: rows at an odd multiple of LPP chunks apart put
  // a quarter-warp's 16-byte reads (4 rows x 2 halves) in 8 distinct banks
  static constexpr int KS = (QC % 2) ? C : C + LPP;
  static constexpr int TILE = P * (KS + C) * 16;  // K rows, then V rows
  static constexpr int FIT = RING_BUDGET / (WARPS * TILE);
  static constexpr int NS = FIT < 2 ? 2 : (FIT > 8 ? 8 : FIT);
  static constexpr int RING = WARPS * NS * TILE;
  static constexpr int COMBINE = WARPS * G * (D + 2) * 4;
  static constexpr int Q_OFF = RING > COMBINE ? RING : COMBINE;
  static constexpr int P_OFF = Q_OFF + G * D * 4;
  static constexpr int BYTES = P_OFF + WARPS * G * P * 4;
  static constexpr int DE = D / 32;    // output columns a lane
  static constexpr bool QREG = G * QC * E <= 64;
  static_assert(C % LPP == 0 && (P * C) % 32 == 0, "tile shape");
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// A 16-byte chunk of the cache as fp32.
template <typename TC>
__device__ __forceinline__ void chunk_f32(const uint4& u, float* f) {
  if constexpr (sizeof(TC) == 2) {
    f[0] = bf_lo(u.x), f[1] = bf_hi(u.x), f[2] = bf_lo(u.y), f[3] = bf_hi(u.y);
    f[4] = bf_lo(u.z), f[5] = bf_hi(u.z), f[6] = bf_lo(u.w), f[7] = bf_hi(u.w);
  } else {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  }
}

// N consecutive cache elements (a lane's output columns of a V row).
template <typename TC, int N>
__device__ __forceinline__ void row_f32(const unsigned char* p,
                                        float (&f)[N]) {
  if constexpr (sizeof(TC) == 2) {
    if constexpr (N == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      f[0] = bf_lo(u.x), f[1] = bf_hi(u.x), f[2] = bf_lo(u.y), f[3] = bf_hi(u.y);
    } else if constexpr (N == 2) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
      f[0] = bf_lo(u), f[1] = bf_hi(u);
    } else {
      f[0] = __uint_as_float(
          static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
    }
  } else {
    if constexpr (N == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
    } else if constexpr (N == 2) {
      const float2 u = *reinterpret_cast<const float2*>(p);
      f[0] = u.x, f[1] = u.y;
    } else {
      f[0] = *reinterpret_cast<const float*>(p);
    }
  }
}

__device__ __forceinline__ float load_q(const void* q, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, size_t i, float x,
                                          int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(out)[i] = x;
}

template <typename TC, int D, int G>
__global__ void __launch_bounds__(NT)
    decode_attn_kernel(const Params p) {
  using Z = Cfg<TC, D, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int bid = blockIdx.x;
  const int split = bid % p.splits;
  bid /= p.splits;
  const int hgrp = bid % p.head_groups;
  bid /= p.head_groups;
  const int kvh = bid % p.KV, b = bid / p.KV;
  const int h0 = kvh * p.g + hgrp * G;         // the group's first query head
  const int ng = min(G, p.g - hgrp * G);       // its query heads
  const int t0 = p.lo + split * p.chunk;       // the block's positions
  const int t1 = min(p.hi, t0 + p.chunk);

  float* qs = reinterpret_cast<float*>(smem + Z::Q_OFF);
  float* pw = reinterpret_cast<float*>(smem + Z::P_OFF) + warp * G * P;
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int h = i / D;
    qs[i] = h < ng ? load_q(p.q, (static_cast<size_t>(b) * p.H + h0) * D + i,
                            p.q_bf16)
                   : 0.f;
  }

  const TC* kb = static_cast<const TC*>(p.k) + b * p.sb + kvh * D;
  const TC* vb = static_cast<const TC*>(p.v) + b * p.sb + kvh * D;
  const int ntiles = (t1 - t0 + P - 1) / P;
  const int mine = ntiles > warp ? (ntiles - warp + WARPS - 1) / WARPS : 0;
  unsigned char* ring = smem + warp * Z::NS * Z::TILE;

  // the warp's j-th tile into stage j % NS: K rows at stride KS chunks,
  // then V rows at stride C; always one commit group, empty past the end
  auto load_tile = [&](int j) {
    if (j < mine) {
      const int ta = t0 + (warp + j * WARPS) * P;
      const int cnt = min(P, t1 - ta);
      unsigned char* st = ring + (j % Z::NS) * Z::TILE;
#pragma unroll
      for (int it = 0; it < P * Z::C / 32; ++it) {
        const int c = lane + 32 * it, r = c / Z::C, col = c % Z::C;
        if (r < cnt) {
          const long long off = (ta + r) * p.st + col * Z::E;
          tc::cp_async16(st + (r * Z::KS + col) * 16, kb + off, true);
          tc::cp_async16(st + (P * Z::KS + r * Z::C + col) * 16, vb + off,
                         true);
        }
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < Z::NS - 1; ++j) load_tile(j);

  __syncthreads();  // q is in shared memory
  const int pos = lane / LPP, half = lane % LPP;
  float qr[Z::QREG ? G : 1][Z::QREG ? Z::QC * Z::E : 1];
  if constexpr (Z::QREG) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int i = 0; i < Z::QC; ++i)
#pragma unroll
        for (int e = 0; e < Z::E; ++e)
          qr[h][i * Z::E + e] = qs[h * D + (i * LPP + half) * Z::E + e];
  }

  float m[G], l[G], o[G][Z::DE];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY, l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < Z::DE; ++e) o[h][e] = 0.f;
  }

  for (int j = 0; j < mine; ++j) {
    load_tile(j + Z::NS - 1);
    cp_async_wait<Z::NS - 1>();  // this lane's copies of tile j are in
    __syncwarp();                // and so are the other lanes'
    const unsigned char* st = ring + (j % Z::NS) * Z::TILE;
    const int cnt = min(P, t1 - (t0 + (warp + j * WARPS) * P));

    // s = q . k for this lane's position, its half of the row's chunks
    float s[G];
#pragma unroll
    for (int h = 0; h < G; ++h) s[h] = 0.f;
    const uint4* krow = reinterpret_cast<const uint4*>(st) + pos * Z::KS;
#pragma unroll
    for (int i = 0; i < Z::QC; ++i) {
      const int c = i * LPP + half;
      float kf[Z::E];
      chunk_f32<TC>(krow[c], kf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if constexpr (Z::QREG) {
#pragma unroll
          for (int e = 0; e < Z::E; ++e)
            s[h] = fmaf(qr[h][i * Z::E + e], kf[e], s[h]);
        } else {
          const float4* qv =
              reinterpret_cast<const float4*>(qs + h * D + c * Z::E);
#pragma unroll
          for (int e4 = 0; e4 < Z::E / 4; ++e4) {
            const float4 x = qv[e4];
            s[h] = fmaf(x.x, kf[4 * e4], s[h]);
            s[h] = fmaf(x.y, kf[4 * e4 + 1], s[h]);
            s[h] = fmaf(x.z, kf[4 * e4 + 2], s[h]);
            s[h] = fmaf(x.w, kf[4 * e4 + 3], s[h]);
          }
        }
      }
    }

    // online softmax over the tile's positions, a query head at a time
    const bool valid = pos < cnt;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float x = s[h] + __shfl_xor_sync(FULL, s[h], 1);
      x *= p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = valid ? x : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = LPP; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[h], mx);  // finite: the tile has a position
      const float alpha = expf(m[h] - mn);
      const float pr = expf(x - mn);     // 0 past the block's positions
      float sum = pr;
#pragma unroll
      for (int off = LPP; off < 32; off <<= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l[h] = fmaf(l[h], alpha, sum);
      m[h] = mn;
#pragma unroll
      for (int e = 0; e < Z::DE; ++e) o[h][e] *= alpha;
      if (half == 0) pw[h * P + pos] = pr;
    }
    __syncwarp();

    // o += p . v over the tile's rows, D / 32 columns a lane
    const unsigned char* vt =
        st + P * Z::KS * 16 + lane * Z::DE * static_cast<int>(sizeof(TC));
    auto row = [&](int r) {
      float vf[Z::DE];
      row_f32<TC, Z::DE>(vt + r * Z::C * 16, vf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float w = pw[h * P + r];
#pragma unroll
        for (int e = 0; e < Z::DE; ++e) o[h][e] = fmaf(w, vf[e], o[h][e]);
      }
    };
    if (cnt == P) {
#pragma unroll
      for (int r = 0; r < P; ++r) row(r);
    } else {
      for (int r = 0; r < cnt; ++r) row(r);
    }
    __syncwarp();  // stage j % NS and the weights are free again
  }

  // join the warps' rows: the ring is free once every warp is here (only
  // empty commit groups can be pending)
  tc::cp_async_wait_all();
  __syncthreads();
  float* co = reinterpret_cast<float*>(smem);  // [WARPS][G][D]
  float* cm = co + WARPS * G * D;              // [WARPS][G]
  float* cl = cm + WARPS * G;
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < Z::DE; ++e)
      co[(warp * G + h) * D + lane * Z::DE + e] = o[h][e];
    if (lane == 0) cm[warp * G + h] = m[h], cl[warp * G + h] = l[h];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += NT) {
    const int h = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, cm[w * G + h]);
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = cm[w * G + h];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      sum = fmaf(cl[w * G + h], f, sum);
      acc = fmaf(co[(w * G + h) * D + d], f, acc);
    }
    const size_t row = static_cast<size_t>(b) * p.H + h0 + h;
    if (p.splits == 1) {
      store_out(p.out, row * D + d, acc / sum, p.q_bf16);
    } else {
      const size_t at = row * p.splits + split;
      p.part_o[at * D + d] = acc;
      if (d == 0) p.part_ml[2 * at] = mx, p.part_ml[2 * at + 1] = sum;
    }
  }
}

// One block a (b, query head), a thread a column: the splits' partials
// joined, o = sum_s o_s exp(m_s - M) / sum_s l_s exp(m_s - M).
__global__ void __launch_bounds__(128)
    decode_attn_merge_kernel(const float* part_o, const float* part_ml,
                             void* out, int D, int splits, int q_bf16) {
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * splits * 2;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float sum = 0.f, acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float f = ml[2 * s] == -INFINITY ? 0.f : expf(ml[2 * s] - mx);
      sum = fmaf(ml[2 * s + 1], f, sum);
      acc = fmaf(part_o[(row * splits + s) * D + d], f, acc);
    }
    store_out(out, row * D + d, acc / sum, q_bf16);
  }
}

template <typename TC, int D, int G>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = Cfg<TC, D, G>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<TC, D, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(B) * p.KV * p.head_groups * p.splits;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  decode_attn_kernel<TC, D, G>
      <<<static_cast<unsigned>(blocks), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  decode_attn_merge_kernel<<<B * p.H, D, 0, stream>>>(
      p.part_o, p.part_ml, p.out, D, p.splits, p.q_bf16);
  return cudaGetLastError();
}

template <typename TC, int D>
cudaError_t dispatch_g(const Params& p, int B, int G, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<TC, D, 1>(p, B, stream);
    case 2: return launch<TC, D, 2>(p, B, stream);
    case 4: return launch<TC, D, 4>(p, B, stream);
    case 8: return launch<TC, D, 8>(p, B, stream);
    case 16: return launch<TC, D, 16>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TC>
cudaError_t dispatch_d(const Params& p, int B, int D, int G,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_g<TC, 32>(p, B, G, stream);
    case 64: return dispatch_g<TC, 64>(p, B, G, stream);
    case 128: return dispatch_g<TC, 128>(p, B, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns the launches' cudaGetLastError() (0 on success).  The caller has
// checked shapes, dtypes and layouts.  cache_dtype and q_dtype: 0 float32,
// 1 bfloat16.  G (1, 2, 4, 8 or 16) query heads a block, head_groups =
// ceil((H / KV) / G); the positions [lo, hi) are attended, cut into splits
// of chunk positions (splits > 1: part_o and part_ml are fp32 scratch of
// (B, H, splits, D) and (B, H, splits, 2), and a second kernel joins
// them).  The cache is copied in 16-byte chunks, so its base and strides
// must be 16-byte aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* out, void* part_o,
                                    void* part_ml, int B, int H, int KV, int D,
                                    int G, int head_groups, long long sb,
                                    long long st, int lo, int hi, int chunk,
                                    int splits, int cache_dtype, int q_dtype,
                                    float scale, float softcap, void* stream) {
  const long long esz = cache_dtype == 1 ? 2 : 4;
  if (!(aligned16(k) && aligned16(v)) || (sb * esz) % 16 || (st * esz) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (KV < 1 || H % KV || lo < 0 || hi <= lo || chunk < 1 || splits < 1 ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, static_cast<float*>(part_o),
           static_cast<float*>(part_ml), sb, st, H, KV, H / KV, lo, hi,
           chunk, splits, head_groups, scale, softcap, q_dtype == 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cache_dtype == 0)
    err = dispatch_d<float>(p, B, D, G, s);
  else if (cache_dtype == 1)
    err = dispatch_d<__nv_bfloat16>(p, B, D, G, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
