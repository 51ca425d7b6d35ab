// Backward flash attention for Hopper (sm_90a): dq, dk, dv of
// softmax(mask(softcap(scale * Q K^T))) V, FlashAttention-2's backward.
//
// The TPU kernel repro/kernels/flash_attention.py:_kernel computes the
// forward only; the reference's attention gradient is jax.grad through its
// plain path (repro/kernels/ref.py:flash_attention_ref).  This kernel is that
// gradient for the port.  From q, k, v, the forward's o, dO and the row
// log-sum-exp lse that the forward kernel stores (natural log):
//   D_i  = sum_d dO_id O_id                      (fp32)
//   P    = exp(s - lse), s the masked, softcapped, scaled logit (0 if masked)
//   dV   = P^T dO          dP = dO V^T           dS = P o (dP - D_i)
//   through the softcap, dS *= 1 - tanh^2(raw / cap)
//   dQ   = scale dS K      dK = scale dS^T Q
// Options as the forward's for q_pos0 = 0 (training's case; the wrapper
// refuses any other): causal or not, window, softcap, GQA (H a multiple of
// KV), D in {16, 32, 64, 128, 192}, float32 or bfloat16 in and out.  No atomics:
// every output element is summed by one warp in a fixed order, so the
// result does not depend on the order in which blocks run.
//
// The entry point picks the kernels by dtype (a dispatch by type, not a
// fallback: no path retries another kernel after a failure):
//
// bf16 (dtype 1): two launches on the stream, on mma.sync.m16n8k16.
//   1. flash_bwd_delta_kernel: D_i in fp32, 16-byte loads of O and dO, a
//      row's chunks over 2-16 neighbouring lanes (3 chunks a lane at D 192)
//      and a shuffle sum; into the delta scratch (B, H, S).
//   2. flash_bwd_bf16_kernel: one grid of two kinds of 4-warp block, the
//      dK/dV blocks first (heaviest key tiles first), then the dQ blocks
//      (heaviest query tiles first).  The two kinds share nothing but D_i,
//      so they run side by side.  A block's tile is 64 rows, or 32 or 16
//      when a grid would not fill one wave of resident blocks (`split` 2 or
//      4, chosen at launch from the grid and the SM count): then 2 or 4
//      warps share each 16-row slice, each taking every split-th 16-row
//      chunk of the streamed tiles, and add their partial sums in shared
//      memory in a fixed order at the end (sum_parts).
//      * dK/dV, one block a (b, KV head, key tile): K and V are loaded
//        once with cp.async; each warp owns 16 keys, and below D 128 their
//        K/V fragments stay in registers (at D 128 they are read again from
//        shared memory with ldmatrix, which keeps the accumulators out of
//        local memory).  The block walks the g = H / KV query heads of its
//        group and the query tiles that can see its keys (from k0 under
//        causal, bounded by the window); the Q, dO, lse and D_i tiles are
//        double-buffered with cp.async.  For each 16-query chunk S^T = K Q^T
//        and dP^T = V dO^T run on the tensor cores; P^T = ex2 of the scaled
//        (softcapped) logit minus lse in log2 units (every exponent <= 0);
//        P^T rounded to bf16 is the A operand of dV += P^T dO (tc_ptx.cuh:
//        the C layout of two n-tiles is the A layout), and dS^T =
//        P^T o (dP^T - D) o (1 - tanh^2) rounded to bf16 the A operand of
//        dK += dS^T Q, with Q and dO read through ldmatrix.trans.  dK and dV
//        stay in registers over the whole group, so GQA's sum needs no
//        second pass.
//      * dQ, one block a (b, head, query tile): the warp's Q and dO
//        fragments stay in registers; the K/V tiles are double-buffered;
//        S = Q K^T and dP = dO V^T per 16-key chunk, dS in registers as the
//        A operand of dQ += dS K (K through ldmatrix.trans).
//      * D 192 (MLA): a thread's dK and dV accumulators at full width
//        would take 2 x 96 fp32 registers on top of the products', so each
//        key tile gets two dK/dV blocks, one a half of the 192 columns (both
//        recompute S^T and dP^T over the whole of D), and the dQ blocks read
//        their Q and dO fragments from shared memory for each chunk instead
//        of holding 2 x 48 in registers.  151 KB of shared memory a block:
//        one block an SM.
//      A chunk that is masked for all of a warp's rows is skipped, and a
//      warp whose 16 rows (or keys) all lie past S (or T) skips its
//      products, so a short sequence runs one warp's chunk, not 64-wide
//      loops.  Shared-memory rows are padded to D + 8 elements, so ldmatrix
//      reads 8 rows from 8 different 16-byte bank groups.  The launch bound
//      asks for 3 blocks an SM up to D 64 (<= 168 registers a thread, no
//      spills), 2 at D 128.
//   Rounding points (ref.flash_attention_bwd_tc_ref mirrors them): the
//   logits are fp32 sums of bf16 q.k, then scaled; P and dS are rounded to
//   bf16 as operands (D_i and dS use the unrounded P); dq, dk, dv are fp32
//   sums rounded once at the store.
//
// fp32 (dtype 0): scalar fp32 FMAs (flash_bwd_dq_f32_kernel, then
//   flash_bwd_dkv_f32_kernel; at D 192 the latter in two column halves, as
//   the bf16 grid), the design of the first port: 128 threads as
//   a 16 x 8 grid, 4 rows x 8 columns of a 64 x 64 score tile each, tiles
//   staged in shared memory.  The dQ kernel also writes D_i.  TF32 would
//   miss the fp32 bar (rel 1e-4), so fp32 stays off the tensor cores; it
//   serves float32-compute training.
//
// What bounds it on an H100.  At jag-surrogate's training shape (B 8, S 128,
// H 4, D 64, bf16, causal) the card's floor is the bytes (q, k, v, o, dO,
// dq, dk, dv and lse, ~4.2 MB: ~1.3 us at 3.35 TB/s; the products are ~0.17
// GFLOP, 0.17 us at 989 TFLOP/s).  The bf16 kernel is bound by latency
// there: at split 2, 128 + 128 blocks on 132 SMs, and the longest warp
// runs a chain of 4 chunks (ldmatrix -> mma -> ex2 -> mma) after its
// loads, behind the D_i pass's launch.  At long sequences (zamba2's 512,
// 32 heads: 2,048 blocks) it is bound by how well 12 warps an SM hide
// mma.sync's and ldmatrix's latencies, far under the tensor cores' rate.
// wgmma with TMA and a producer warp is the later step.
//
// Masked logits are dropped (P = 0) where the forward uses the finite -1e30;
// for a row that sees at least one key the two agree exactly, and with
// q_pos0 = 0 every row does unless it is non-causal with a window that
// leaves it no key (S >= T + window), which this kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_ptx.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int TY = 16;        // fp32 thread grid rows
constexpr int TX = 8;         // fp32 thread grid columns
constexpr int NT = TY * TX;   // threads per block (both dtypes)
constexpr int RQ = BQ / TY;   // tile rows per thread
constexpr int CK = BK / TX;   // tile columns per thread
constexpr int NW = NT / 32;   // bf16: warps per block, 16 rows each
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == BK, "the tiles share one thread layout");
static_assert(NW * 16 == BQ, "the bf16 warps split a tile into 16-row slices");

// dK/dV columns a block computes: all of D up to 128; at D 192 half, so
// that a thread's dK and dV accumulators fit in registers (2 x 96 fp32 in
// the bf16 layout at full width, 2 x 4 x 24 in the fp32 one).  Each half
// recomputes the scores over the whole of D.
template <int D>
constexpr int kDkvCols = D > 128 ? D / 2 : D;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S) scratch: D_i
  void* dq;
  void* dk;
  void* dv;
  int B, S, T, H, KV;
  float scale;
  float softcap;  // <= 0: no softcap
  int causal;
  int window;     // <= 0: no window
  int split;      // bf16: warps that share a 16-row slice (1, 2 or 4)
};

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

// rows [row0, row0 + rows) x D of a (., D) matrix with row stride `stride`
// into shared memory with rows of D + 1; rows at or past `limit` are 0.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int rows, int limit) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = row0 + r;
    dst[r * (D + 1) + c] = t < limit ? src[t * stride + c] : 0.f;
  }
}

// s[i][j] = sum_d A[ty + TY i][d] B[tx + TX j][d]; rows of D + 1 floats.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[RQ][CK], const float* A,
                                         const float* Bm, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RQ], b[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) a[i] = A[(ty + TY * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < CK; ++j) b[j] = Bm[(tx + TX * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// From s = q.k (unscaled) and dp = dO.v of the thread's 4 x 8 cells of the
// tile at (q0, k0): s <- P, dp <- dS (through the softcap; not yet scaled).
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[RQ][CK], float (&dp)[RQ][CK], const float* lse_s,
    const float* delta_s, int q0, int k0, int ty, int tx, const Params& p) {
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = ty + TY * i;
    const int qpos = q0 + row;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int kpos = k0 + tx + TX * j;
      bool keep = qpos < p.S && kpos < p.T;
      if (p.causal) keep = keep && qpos >= kpos;
      if (p.window > 0) keep = keep && (qpos - kpos) < p.window;
      const float raw = s[i][j] * p.scale;
      float x = raw, dcap = 1.f;
      if (p.softcap > 0.f) {
        const float t = tanhf(raw / p.softcap);
        x = p.softcap * t;
        dcap = 1.f - t * t;
      }
      const float pr = keep ? expf(x - lse_s[row]) : 0.f;
      s[i][j] = pr;
      dp[i][j] = pr * (dp[i][j] - delta_s[row]) * dcap;
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V; dS; lse, D_i
  return sizeof(float) * (4 * BQ * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO; P, dS; lse, D_i
  return sizeof(float) * (4 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

// 1. dQ and D_i: one block a (b, h, 64-query tile).
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_f32_kernel(const Params p) {
  static_assert(D % TX == 0, "head dim must split over the thread columns");
  constexpr int DC = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x (D+1)
  float* dOs = Qs + BQ * (D + 1);      // BQ x (D+1)
  float* Ks = dOs + BQ * (D + 1);      // BK x (D+1); O's rows at first
  float* Vs = Ks + BK * (D + 1);       // BK x (D+1)
  float* dSs = Vs + BK * (D + 1);      // BQ x (BK+1)
  float* lse_s = dSs + BQ * (BK + 1);  // BQ
  float* delta_s = lse_s + BQ;         // BQ

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long long q_row = (long long)p.H * D;
  const long long kv_row = (long long)p.KV * D;
  const long long q_off = (long long)b * p.S * q_row + (long long)h * D;
  const long long kv_off = (long long)b * p.T * kv_row + (long long)kvh * D;
  const float* qb = static_cast<const float*>(p.q) + q_off;
  const float* ob = static_cast<const float*>(p.o) + q_off;
  const float* dob = static_cast<const float*>(p.dout) + q_off;
  const float* kb = static_cast<const float*>(p.k) + kv_off;
  const float* vb = static_cast<const float*>(p.v) + kv_off;
  float* dqb = static_cast<float*>(p.dq) + q_off;
  const long long row_off = ((long long)b * p.H + h) * p.S;

  load_rows<D>(Qs, qb, q_row, q0, BQ, p.S);
  load_rows<D>(dOs, dob, q_row, q0, BQ, p.S);
  load_rows<D>(Ks, ob, q_row, q0, BQ, p.S);  // O, for D_i
  __syncthreads();
  for (int r = tid; r < BQ; r += NT) {
    const int s = q0 + r;
    float acc = 0.f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(dOs[r * (D + 1) + d], Ks[r * (D + 1) + d], acc);
    delta_s[r] = acc;
    lse_s[r] = s < p.S ? p.lse[row_off + s] : 0.f;
    if (s < p.S) p.delta[row_off + s] = acc;
  }

  float acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int q_last = min(q0 + BQ, p.S) - 1;
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // O's rows read; last tile's K/V/dS reads finished
    load_rows<D>(Ks, kb, kv_row, k0, BK, p.T);
    load_rows<D>(Vs, vb, kv_row, k0, BK, p.T);
    __syncthreads();
    float s[RQ][CK], dp[RQ][CK];
    tile_dot<D>(s, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
    probs_and_dscores(s, dp, lse_s, delta_s, q0, k0, ty, tx, p);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j)
        dSs[(ty + TY * i) * (BK + 1) + tx + TX * j] = dp[i][j];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = dSs[(ty + TY * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[kk * (D + 1) + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q0 + ty + TY * i;
    if (s >= p.S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[s * q_row + tx + TX * c] = acc[i][c] * p.scale;
  }
}

// 2. dK and dV: one block a (b, KV head, 64-key tile), summing over the
// query heads of its group.  Runs after kernel 1 (D_i).
template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int DH = kDkvCols<D>;
  constexpr int DC = DH / TX;
  static_assert(DH % TX == 0, "dK/dV columns must split over the threads");
  extern __shared__ float smem[];
  float* Ks = smem;                    // BK x (D+1)
  float* Vs = Ks + BK * (D + 1);       // BK x (D+1)
  float* Qs = Vs + BK * (D + 1);       // BQ x (D+1)
  float* dOs = Qs + BQ * (D + 1);      // BQ x (D+1)
  float* Ps = dOs + BQ * (D + 1);      // BQ x (BK+1)
  float* dSs = Ps + BQ * (BK + 1);     // BQ x (BK+1)
  float* lse_s = dSs + BQ * (BK + 1);  // BQ
  float* delta_s = lse_s + BQ;         // BQ

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int k0 = (blockIdx.x / (D / DH)) * BK;
  const int col0 = (blockIdx.x % (D / DH)) * DH;  // this block's columns
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = p.H / p.KV;
  const long long q_row = (long long)p.H * D;
  const long long kv_row = (long long)p.KV * D;
  const long long kv_off = (long long)b * p.T * kv_row + (long long)kvh * D;
  const float* kb = static_cast<const float*>(p.k) + kv_off;
  const float* vb = static_cast<const float*>(p.v) + kv_off;
  float* dkb = static_cast<float*>(p.dk) + kv_off;
  float* dvb = static_cast<float*>(p.dv) + kv_off;

  load_rows<D>(Ks, kb, kv_row, k0, BK, p.T);
  load_rows<D>(Vs, vb, kv_row, k0, BK, p.T);

  // this thread's cells of dK and dV: keys ty + TY a, columns col0 + tx +
  // TX c
  float dk[RQ][DC], dv[RQ][DC];
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[a][c] = dv[a][c] = 0.f;

  // query range that can see a key of this tile
  const int k_last = min(k0 + BK, p.T) - 1;
  const int q_lo = p.causal ? k0 : 0;
  int q_hi = p.S;
  if (p.window > 0) q_hi = min(q_hi, k_last + p.window);

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const long long q_off = (long long)b * p.S * q_row + (long long)h * D;
    const float* qb = static_cast<const float*>(p.q) + q_off;
    const float* dob = static_cast<const float*>(p.dout) + q_off;
    const long long row_off = ((long long)b * p.H + h) * p.S;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // last tile's Q/dO/P/dS reads finished
      load_rows<D>(Qs, qb, q_row, q0, BQ, p.S);
      load_rows<D>(dOs, dob, q_row, q0, BQ, p.S);
      for (int r = tid; r < BQ; r += NT) {
        const int s = q0 + r;
        lse_s[r] = s < p.S ? p.lse[row_off + s] : 0.f;
        delta_s[r] = s < p.S ? p.delta[row_off + s] : 0.f;
      }
      __syncthreads();
      float s[RQ][CK], dp[RQ][CK];
      tile_dot<D>(s, Qs, Ks, ty, tx);
      tile_dot<D>(dp, dOs, Vs, ty, tx);
      probs_and_dscores(s, dp, lse_s, delta_s, q0, k0, ty, tx, p);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          Ps[(ty + TY * i) * (BK + 1) + tx + TX * j] = s[i][j];
          dSs[(ty + TY * i) * (BK + 1) + tx + TX * j] = dp[i][j];
        }
      __syncthreads();
      const int rows = min(BQ, p.S - q0);  // padded rows hold P = dS = 0
#pragma unroll 2
      for (int i = 0; i < rows; ++i) {
        float pv[RQ], dsv[RQ];
#pragma unroll
        for (int a = 0; a < RQ; ++a) {
          pv[a] = Ps[i * (BK + 1) + ty + TY * a];
          dsv[a] = dSs[i * (BK + 1) + ty + TY * a];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float qv = Qs[i * (D + 1) + col0 + tx + TX * c];
          const float dov = dOs[i * (D + 1) + col0 + tx + TX * c];
#pragma unroll
          for (int a = 0; a < RQ; ++a) {
            dv[a][c] = fmaf(pv[a], dov, dv[a][c]);
            dk[a][c] = fmaf(dsv[a], qv, dk[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int t = k0 + ty + TY * a;
    if (t >= p.T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[t * kv_row + col0 + tx + TX * c] = dk[a][c] * p.scale;
      dvb[t * kv_row + col0 + tx + TX * c] = dv[a][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// 1. D_i = sum_d dO_id O_id: a row's D / 8 16-byte chunks are taken by
// kDeltaLanes<D> neighbouring lanes (a power of two, so a row lies within a
// warp), each adding every kDeltaLanes-th chunk, then a shuffle sum; rows
// of the (B, S, H) rows.
template <int D>
constexpr int kDeltaLanes = (D / 8) & -(D / 8);  // 2, 4, 8, 16; 8 at D 192

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(const Params p) {
  constexpr int CPR = D / 8;  // chunks a row
  constexpr int LPR = kDeltaLanes<D>;
  static_assert(LPR <= 32 && CPR % LPR == 0, "a row's lanes within a warp");
  const long long rows = (long long)p.B * p.S * p.H;
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  const long long r = i / LPR;
  float acc = 0.f;
  if (r < rows) {
#pragma unroll
    for (int c = (int)(i % LPR); c < CPR; c += LPR) {
      const long long off = r * D + c * 8;
      const uint4 a = *reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(p.o) + off);
      const uint4 b = *reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(p.dout) + off);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(b2[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && i % LPR == 0) {  // r = (b S + s) H + h
    const int h = (int)(r % p.H);
    const long long bs = r / p.H;
    const int s = (int)(bs % p.S), b = (int)(bs / p.S);
    p.delta[((long long)b * p.H + h) * p.S + s] = acc;
  }
}

// rows [row0, row0 + rows) x D of a (., D) bf16 matrix with row stride
// `stride` into shared memory with rows of LD elements, 16 bytes a
// cp.async; rows past `limit` are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int rows, int limit) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < rows * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int t = row0 + r;
    const bool in = t < limit;
    tc::cp_async16(dst + r * LD + c, src + (in ? t : 0) * stride + c, in);
  }
}

// BQ floats of a (B, H, S) vector from row `row0` on, zero past `limit`.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int limit) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool in = row0 + r < limit;
    tc::cp_async4(dst + r, src + (in ? row0 + r : 0), in);
  }
}

template <int D>
constexpr size_t bf16_smem_bytes() {  // 2 stationary + 2 x 2 streamed tiles
  return sizeof(bf16) * 6 * BQ * (D + 8) + sizeof(float) * 4 * BQ;
}

// P (or P^T) and dS (dS^T) of one 16 x 16 chunk from the fp32 products
// s = q.k and dp = dO.v, in place.  Element (n, e) of the two n-tiles lies
// at row row0 + 8 (e / 2) and column col0 + 8 n + e % 2 of the
// chunk, the thread's row0 and col0 being those of (0, 0); `lse2(n, e)` and
// `dl(n, e)` give the element's query's lse (log2 units) and D_i.
template <bool kRowsAreQueries, typename Lse, typename Delta>
__device__ __forceinline__ void chunk_probs(float (&s)[2][4], float (&dp)[2][4],
                                            int row0, int col0, bool masked,
                                            const Params& p, Lse lse2,
                                            Delta dl) {
  const float scale_log2 = p.scale * LOG2E;
  const float cap_log2 = p.softcap * LOG2E;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e / 2);
      const int col = col0 + 8 * n + e % 2;
      float x = s[n][e] * scale_log2, dcap = 1.f;
      if (p.softcap > 0.f) {
        const float t = tanhf(s[n][e] * p.scale / p.softcap);
        x = cap_log2 * t;
        dcap = 1.f - t * t;
      }
      float pr = exp2f(x - lse2(n, e));
      if (masked) {
        const int qpos = kRowsAreQueries ? row : col;
        const int kpos = kRowsAreQueries ? col : row;
        bool keep = qpos < p.S && kpos < p.T;
        if (p.causal) keep = keep && qpos >= kpos;
        if (p.window > 0) keep = keep && (qpos - kpos) < p.window;
        pr = keep ? pr : 0.f;
      }
      s[n][e] = pr;
      dp[n][e] = pr * (dp[n][e] - dl(n, e)) * dcap;
    }
}

// The C fragments of a chunk's two n-tiles as the A fragment of a product
// over its 16 columns, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = tc::pack_bf16(c[0][0], c[0][1]);
  a[1] = tc::pack_bf16(c[0][2], c[0][3]);
  a[2] = tc::pack_bf16(c[1][0], c[1][1]);
  a[3] = tc::pack_bf16(c[1][2], c[1][3]);
}

// Store a warp's 16 rows x D fp32 accumulator times `mul` as bf16 rows of
// stride `stride`, rows at or past `limit` skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4],
                                           long long stride, int row0,
                                           int limit, float mul) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + g + 8 * i;
    if (t >= limit) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + t * stride + n * 8 + 2 * q4) =
          tc::pack_bf16(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// Sum the accumulators of the p.split warps that share a 16-row slice in
// shared memory `red` (which overlays the streamed tiles): parts 1.. write
// theirs, part 0 adds them in part order, so the sum does not depend on the
// order in which warps run.  Every thread of the block calls it.
template <int NA, int ND>
__device__ __forceinline__ void sum_parts(float (&acc)[NA][ND][4], float* red,
                                          const Params& p, int slice,
                                          int part) {
  constexpr int PER = NA * ND * 4;  // floats a thread holds
  const int lane = threadIdx.x % 32;
  const int slices = NW / p.split;
  __syncthreads();  // every warp is done with the tiles `red` overlays
  if (part > 0) {
    float* dst = red + ((part - 1) * slices + slice) * PER * 32 + lane;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[((a * ND + n) * 4 + c) * 32] = acc[a][n][c];
  }
  __syncthreads();
  if (part == 0) {
    for (int pp = 1; pp < p.split; ++pp) {
      const float* src = red + ((pp - 1) * slices + slice) * PER * 32 + lane;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][n][c] += src[((a * ND + n) * 4 + c) * 32];
    }
  }
}

// 2a. dK and dV: one block a (b, KV head, tile of 16 x 4 / split keys),
// summing over the query heads of its group.  Warp w owns the 16-key slice
// w % (4 / split) and takes every split-th 16-query chunk from w / (4 /
// split) on; the parts meet in sum_parts.
template <int D>
__device__ __forceinline__ void dkv_block(const Params& p, int kt, int kvh,
                                          int b, int col0,
                                          unsigned char* smem_raw) {
  constexpr int LD = D + 8;    // padded shared-memory row
  constexpr int KD = D / 16;   // k-steps over d
  constexpr int ND = kDkvCols<D> / 8;  // n-tiles of this block's columns
  constexpr bool kFragsInRegs = D <= 64;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BK x LD
  bf16* Vs = Ks + BK * LD;                       // BK x LD
  bf16* Qs = Vs + BK * LD;                       // 2 stages of BQ x LD
  bf16* dOs = Qs + 2 * BQ * LD;                  // 2 stages of BQ x LD
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // 2 x BQ
  float* dl_s = lse_s + 2 * BQ;                                // 2 x BQ

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int q4 = lane % 4;
  const int g = p.H / p.KV;
  const int slices = NW / p.split, rows = 16 * slices;
  const int slice = warp % slices, part = warp / slices;
  const int k0 = kt * rows;
  const long long q_row = (long long)p.H * D;
  const long long kv_row = (long long)p.KV * D;
  const long long kv_off = (long long)b * p.T * kv_row + (long long)kvh * D;

  const int k_last = min(k0 + rows, p.T) - 1;
  const int q_lo = p.causal ? k0 : 0;
  int q_hi = p.S;
  if (p.window > 0) q_hi = min(q_hi, k_last + p.window);
  const int nqt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_tiles = g * nqt;

  // tile j: head kvh g + j / nqt, rows from q_lo + (j % nqt) BQ
  auto load_q = [&](int j, int stage) {
    const int h = kvh * g + j / nqt;
    const int q0 = q_lo + (j % nqt) * BQ;
    const long long q_off = (long long)b * p.S * q_row + (long long)h * D;
    const long long row_off = ((long long)b * p.H + h) * p.S;
    load_tile<D, LD>(Qs + stage * BQ * LD, static_cast<const bf16*>(p.q) + q_off,
                     q_row, q0, BQ, p.S);
    load_tile<D, LD>(dOs + stage * BQ * LD,
                     static_cast<const bf16*>(p.dout) + q_off, q_row, q0, BQ,
                     p.S);
    load_vec(lse_s + stage * BQ, p.lse + row_off, q0, p.S);
    load_vec(dl_s + stage * BQ, p.delta + row_off, q0, p.S);
  };

  load_tile<D, LD>(Ks, static_cast<const bf16*>(p.k) + kv_off, kv_row, k0,
                   rows, p.T);
  load_tile<D, LD>(Vs, static_cast<const bf16*>(p.v) + kv_off, kv_row, k0,
                   rows, p.T);
  if (n_tiles > 0) load_q(0, 0);
  tc::cp_async_commit();

  const int kw = k0 + 16 * slice;  // this warp's 16 keys
  const bool live = kw < p.T;
  const bf16* Kw = Ks + 16 * slice * LD;
  const bf16* Vw = Vs + 16 * slice * LD;
  uint32_t kf[kFragsInRegs ? KD : 1][4], vf[kFragsInRegs ? KD : 1][4];
  float acc[2][ND][4];  // dK, dV
  float(&dk)[ND][4] = acc[0];
  float(&dv)[ND][4] = acc[1];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_lo + (j % nqt) * BQ;
    tc::cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < n_tiles) {  // into the stage tile j - 1 used
      load_q(j + 1, (j + 1) & 1);
      tc::cp_async_commit();
    }
    if (!live) continue;
    if constexpr (kFragsInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int off = (lane % 16) * LD + kk * 16 + (lane / 16) * 8;
          tc::ldsm_x4(kf[kk], Kw + off);
          tc::ldsm_x4(vf[kk], Vw + off);
        }
      }
    }
    const bf16* Qt = Qs + (j & 1) * BQ * LD;
    const bf16* dOt = dOs + (j & 1) * BQ * LD;
    const float* lse_t = lse_s + (j & 1) * BQ;
    const float* dl_t = dl_s + (j & 1) * BQ;

#pragma unroll 1
    for (int c = part; c < BQ / 16; c += p.split) {
      const int qc = q0 + 16 * c;
      if (qc >= p.S) break;
      if (p.causal && qc + 15 < kw) continue;  // every query before every key
      if (p.window > 0 && qc - (kw + 15) >= p.window) break;  // all too far
      // S^T = K Q^T and dP^T = V dO^T over the chunk's 16 queries
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t bq[4], bo[4];
        const int off = (16 * c + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8;
        tc::ldsm_x4(bq, Qt + off);
        tc::ldsm_x4(bo, dOt + off);
        if constexpr (kFragsInRegs) {
          tc::mma_bf16(s[0], kf[kk], bq[0], bq[1]);
          tc::mma_bf16(s[1], kf[kk], bq[2], bq[3]);
          tc::mma_bf16(dp[0], vf[kk], bo[0], bo[1]);
          tc::mma_bf16(dp[1], vf[kk], bo[2], bo[3]);
        } else {  // D 128: K and V fragments from shared memory
          uint32_t a[4];
          const int aoff = (lane % 16) * LD + kk * 16 + (lane / 16) * 8;
          tc::ldsm_x4(a, Kw + aoff);
          tc::mma_bf16(s[0], a, bq[0], bq[1]);
          tc::mma_bf16(s[1], a, bq[2], bq[3]);
          tc::ldsm_x4(a, Vw + aoff);
          tc::mma_bf16(dp[0], a, bo[0], bo[1]);
          tc::mma_bf16(dp[1], a, bo[2], bo[3]);
        }
      }
      // rows are keys, columns queries: lse and D_i by column
      const bool masked = qc + 16 > p.S || kw + 16 > p.T ||
                          (p.causal && qc < kw + 15) ||
                          (p.window > 0 && qc + 15 - kw >= p.window);
      const int col = 16 * c + 2 * q4;  // the thread's first column in the tile
      chunk_probs<false>(
          s, dp, kw + lane / 4, qc + 2 * q4, masked, p,
          [&](int n, int e) { return lse_t[col + 8 * n + e % 2] * LOG2E; },
          [&](int n, int e) { return dl_t[col + 8 * n + e % 2]; });
      uint32_t pa[4], da[4];
      to_a(pa, s);
      to_a(da, dp);
      // dV += P^T dO, dK += dS^T Q: dO and Q as (query, d), read transposed
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t bt[4];
        const int off = (16 * c + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                        col0 + np * 16 + (lane / 16) * 8;
        tc::ldsm_x4_trans(bt, dOt + off);
        tc::mma_bf16(dv[2 * np], pa, bt[0], bt[1]);
        tc::mma_bf16(dv[2 * np + 1], pa, bt[2], bt[3]);
        tc::ldsm_x4_trans(bt, Qt + off);
        tc::mma_bf16(dk[2 * np], da, bt[0], bt[1]);
        tc::mma_bf16(dk[2 * np + 1], da, bt[2], bt[3]);
      }
    }
  }
  tc::cp_async_wait_all();  // nothing in flight at exit
  if (p.split > 1) {
    sum_parts(acc, reinterpret_cast<float*>(Qs), p, slice, part);
    if (part > 0) return;
  }

  store_rows<kDkvCols<D>>(static_cast<bf16*>(p.dk) + kv_off + col0, dk,
                          kv_row, kw, p.T, p.scale);
  store_rows<kDkvCols<D>>(static_cast<bf16*>(p.dv) + kv_off + col0, dv,
                          kv_row, kw, p.T, 1.f);
}

// 2b. dQ: one block a (b, head, tile of 16 x 4 / split queries), its warps
// split as dkv_block's.
template <int D>
__device__ __forceinline__ void dq_block(const Params& p, int qt, int h,
                                         int b, unsigned char* smem_raw) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* dOs = Qs + BQ * LD;                      // BQ x LD
  bf16* Ks = dOs + BQ * LD;                      // 2 stages of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                   // 2 stages of BK x LD

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int q4 = lane % 4;
  const int kvh = h / (p.H / p.KV);
  const int slices = NW / p.split, rows = 16 * slices;
  const int slice = warp % slices, part = warp / slices;
  const int q0 = qt * rows;
  const long long q_row = (long long)p.H * D;
  const long long kv_row = (long long)p.KV * D;
  const long long q_off = (long long)b * p.S * q_row + (long long)h * D;
  const long long kv_off = (long long)b * p.T * kv_row + (long long)kvh * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + kv_off;
  const bf16* vb = static_cast<const bf16*>(p.v) + kv_off;

  const int q_last = min(q0 + rows, p.S) - 1;
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  load_tile<D, LD>(Qs, static_cast<const bf16*>(p.q) + q_off, q_row, q0, rows,
                   p.S);
  load_tile<D, LD>(dOs, static_cast<const bf16*>(p.dout) + q_off, q_row, q0,
                   rows, p.S);
  if (n_tiles > 0) {
    load_tile<D, LD>(Ks, kb, kv_row, k_lo, BK, p.T);
    load_tile<D, LD>(Vs, vb, kv_row, k_lo, BK, p.T);
  }
  tc::cp_async_commit();

  const int qw = q0 + 16 * slice;  // this warp's 16 rows
  const bool live = qw < p.S;
  // the thread's rows qw + lane / 4 and + 8: lse (log2 units) and D_i
  const long long row_off = ((long long)b * p.H + h) * p.S;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = qw + lane / 4 + 8 * i;
    lse2[i] = s < p.S ? p.lse[row_off + s] * LOG2E : 0.f;
    dl[i] = s < p.S ? p.delta[row_off + s] : 0.f;
  }
  // Q / dO fragments stay in registers up to D 128; at D 192 they are read
  // from shared memory for each chunk, which keeps the accumulators there
  constexpr bool kFragsInRegs = D <= 128;
  uint32_t qf[kFragsInRegs ? KD : 1][4], of[kFragsInRegs ? KD : 1][4];
  float accs[1][ND][4];
  float(&acc)[ND][4] = accs[0];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_lo + j * BK;
    tc::cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      load_tile<D, LD>(Ks + st * BK * LD, kb, kv_row, k0 + BK, BK, p.T);
      load_tile<D, LD>(Vs + st * BK * LD, vb, kv_row, k0 + BK, BK, p.T);
      tc::cp_async_commit();
    }
    if (!live) continue;
    if constexpr (kFragsInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int off =
              (16 * slice + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
          tc::ldsm_x4(qf[kk], Qs + off);
          tc::ldsm_x4(of[kk], dOs + off);
        }
      }
    }
    const bf16* Kt = Ks + (j & 1) * BK * LD;
    const bf16* Vt = Vs + (j & 1) * BK * LD;

#pragma unroll 1
    for (int c = part; c < BK / 16; c += p.split) {
      const int kc = k0 + 16 * c;
      if (kc >= p.T) break;
      if (p.causal && kc > qw + 15) break;  // every key after every query
      if (p.window > 0 && qw - (kc + 15) >= p.window) continue;  // too far
      // S = Q K^T and dP = dO V^T over the chunk's 16 keys
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t bk[4], bv[4];
        const int off = (16 * c + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8;
        tc::ldsm_x4(bk, Kt + off);
        tc::ldsm_x4(bv, Vt + off);
        if constexpr (kFragsInRegs) {
          tc::mma_bf16(s[0], qf[kk], bk[0], bk[1]);
          tc::mma_bf16(s[1], qf[kk], bk[2], bk[3]);
          tc::mma_bf16(dp[0], of[kk], bv[0], bv[1]);
          tc::mma_bf16(dp[1], of[kk], bv[2], bv[3]);
        } else {  // D 192: Q and dO fragments from shared memory
          uint32_t a[4];
          const int aoff =
              (16 * slice + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
          tc::ldsm_x4(a, Qs + aoff);
          tc::mma_bf16(s[0], a, bk[0], bk[1]);
          tc::mma_bf16(s[1], a, bk[2], bk[3]);
          tc::ldsm_x4(a, dOs + aoff);
          tc::mma_bf16(dp[0], a, bv[0], bv[1]);
          tc::mma_bf16(dp[1], a, bv[2], bv[3]);
        }
      }
      // rows are queries, columns keys: lse and D_i by row
      const bool masked = kc + 16 > p.T || qw + 16 > p.S ||
                          (p.causal && kc + 15 > qw) ||
                          (p.window > 0 && qw + 15 - kc >= p.window);
      chunk_probs<true>(
          s, dp, qw + lane / 4, kc + 2 * q4, masked, p,
          [&](int, int e) { return lse2[e / 2]; },
          [&](int, int e) { return dl[e / 2]; });
      uint32_t da[4];
      to_a(da, dp);
      // dQ += dS K: K as (key, d), read transposed
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t bt[4];
        tc::ldsm_x4_trans(bt, Kt + (16 * c + ((lane / 8) % 2) * 8 + lane % 8) *
                                       LD + np * 16 + (lane / 16) * 8);
        tc::mma_bf16(acc[2 * np], da, bt[0], bt[1]);
        tc::mma_bf16(acc[2 * np + 1], da, bt[2], bt[3]);
      }
    }
  }
  tc::cp_async_wait_all();  // nothing in flight at exit
  if (p.split > 1) {
    sum_parts(accs, reinterpret_cast<float*>(Ks), p, slice, part);
    if (part > 0) return;
  }

  store_rows<D>(static_cast<bf16*>(p.dq) + q_off, acc, q_row, qw, p.S,
                p.scale);
}

// Blocks an SM holds (registers bound it: ptxas fits D <= 64 in 168 a
// thread without spills, D 128 needs ~246; at D 192 shared memory, 151 KB a
// block, leaves one).
template <int D>
constexpr int kMinBlocks = D <= 64 ? 3 : D <= 128 ? 2 : 1;

// 2. One grid: n_dkv dK/dV blocks (key tile slowest, so under causal the
// key tiles that see the most queries start first; at D 192 two blocks a
// tile, one a half of the columns), then the dQ blocks (under causal the
// last query tiles first).
template <int D>
__global__ void __launch_bounds__(NT, kMinBlocks<D>)
    flash_bwd_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = 16 * (NW / p.split);  // keys or queries a block
  const int nk = (p.T + rows - 1) / rows;
  const int nq = (p.S + rows - 1) / rows;
  constexpr int halves = D / kDkvCols<D>;  // column blocks of dK/dV
  const int n_dkv = nk * p.KV * p.B * halves;
  int i = blockIdx.x;
  if (i < n_dkv) {
    const int col0 = (i % halves) * kDkvCols<D>;
    i /= halves;
    dkv_block<D>(p, i / (p.KV * p.B), i % p.KV, (i / p.KV) % p.B, col0,
                 smem_raw);
  } else {
    i -= n_dkv;
    const int rank = i / (p.H * p.B);
    dq_block<D>(p, p.causal ? nq - 1 - rank : rank, i % p.H, (i / p.H) % p.B,
                smem_raw);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_with(K kernel, size_t smem, dim3 grid, const Params& p,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int nq = (p.S + BQ - 1) / BQ;
  const int nk = (p.T + BK - 1) / BK;
  cudaError_t err = launch_with(flash_bwd_dq_f32_kernel<D>, dq_smem_bytes<D>(),
                                dim3(nq, p.H, p.B), p, stream);
  if (err != cudaSuccess) return err;
  return launch_with(flash_bwd_dkv_f32_kernel<D>, dkv_smem_bytes<D>(),
                     dim3(nk * (D / kDkvCols<D>), p.KV, p.B), p, stream);
}

// Blocks of the bf16 grid when `split` warps share each 16-row slice.
template <int D>
long long bf16_blocks(const Params& p, int split) {
  const int rows = 16 * (NW / split);
  return (long long)((p.T + rows - 1) / rows) * p.KV * p.B *
             (D / kDkvCols<D>) +
         (long long)((p.S + rows - 1) / rows) * p.H * p.B;
}

template <int D>
cudaError_t launch_bf16(Params p, cudaStream_t stream) {
  const long long chunks = (long long)p.B * p.S * p.H * kDeltaLanes<D>;
  cudaError_t err = launch_with(flash_bwd_delta_kernel<D>, 0,
                                dim3((unsigned)((chunks + NT - 1) / NT)), p,
                                stream);
  if (err != cudaSuccess) return err;
  // A grid within one wave of resident blocks is bound by its longest
  // warp's chain of chunks: sharing each slice among `split` warps cuts the
  // chain by that factor, for partial sums to add and tiles loaded by more
  // blocks.  So take the largest split whose grid still fits one wave and
  // has more blocks than the split before (short sequences gain none); a
  // grid of waves keeps one warp a slice.
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long slots = (long long)sms * kMinBlocks<D>;
  p.split = 1;
  for (int split = 2; split <= NW; split *= 2)
    if (bf16_blocks<D>(p, split) <= slots &&
        bf16_blocks<D>(p, split) > bf16_blocks<D>(p, split / 2))
      p.split = split;
  return launch_with(flash_bwd_bf16_kernel<D>, bf16_smem_bytes<D>(),
                     dim3((unsigned)bf16_blocks<D>(p, p.split)), p, stream);
}

template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  return dtype == 1 ? launch_bf16<D>(p, stream) : launch_f32<D>(p, stream);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns the first failing launch's cudaGetLastError() (0 on success).  The
// caller has checked shapes, dtype and contiguity (q, o, dout, dq: (B,S,H,D);
// k, v, dk, dv: (B,T,KV,D); lse and delta: float32 (B,H,S)); dtype 0 is
// float32, 1 is bfloat16.  delta is scratch the kernels share.  The bf16
// kernels copy 16-byte chunks, so their eight tensors must be 16-byte
// aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int S, int T,
                                   int H, int KV, int D, int dtype,
                                   float scale, float softcap, int causal,
                                   int window, void* stream) {
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T, H, KV,
           scale, softcap, causal, window, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    for (const void* t : {q, k, v, o, dout, (const void*)dq, (const void*)dk,
                          (const void*)dv})
      if (!aligned16(t)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(p, dtype, st); break;
    case 32: err = launch<32>(p, dtype, st); break;
    case 64: err = launch<64>(p, dtype, st); break;
    case 128: err = launch<128>(p, dtype, st); break;
    case 192: err = launch<192>(p, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
