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
// KV), D in {16, 32, 64, 128}, float32 or bfloat16 in and out.
//
// Two kernels on the stream, in order, and no atomics, so the result does
// not depend on the order in which blocks run:
//   1. flash_bwd_dq_kernel, one block a (b, h, 64-query tile): computes D_i
//      of its rows (stored for kernel 2) and walks the key tiles its rows
//      can see, accumulating dQ in registers;
//   2. flash_bwd_dkv_kernel, one block a (b, KV head, 64-key tile): walks
//      the g = H / KV query heads of its group and the query tiles that can
//      see its keys, so GQA's sum over the group stays in registers.
// Both recompute P from lse.  Every product runs on scalar fp32 FMAs over
// tiles staged in shared memory as fp32 (bf16 inputs are widened on the
// load, the outputs rounded once at the store), with the forward's fp32
// thread layout: 128 threads as a 16 x 8 grid, 4 rows x 8 columns of a
// 64 x 64 score tile each.  Nothing is rounded to bf16 inside, so the plain
// version ref.flash_attention_bwd_ref (fp32 throughout) is its mirror for
// both dtypes.
//
// What bounds it on an H100.  At jag-surrogate's training shape (B 8, S 128,
// H 4, D 64, bf16, causal) the card's floor is the bytes (q, k, v, o, dO,
// dq, dk, dv and lse, ~4.2 MB: ~1.3 us at 3.35 TB/s; the products are ~0.17
// GFLOP).  This kernel is far from it: 64 blocks a kernel (under one wave of
// 132 SMs), each a chain of scalar 64 x 64 x D products out of shared
// memory.  mma.sync (as the forward's bf16 kernel), wgmma with TMA and one
// fused pass are the later redesigns.
//
// Masked logits are dropped (P = 0) where the forward uses the finite -1e30;
// for a row that sees at least one key the two agree exactly, and with
// q_pos0 = 0 every row does unless it is non-causal with a window that
// leaves it no key (S >= T + window), which this kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int TY = 16;        // thread grid rows
constexpr int TX = 8;         // thread grid columns
constexpr int NT = TY * TX;   // threads per block
constexpr int RQ = BQ / TY;   // tile rows per thread
constexpr int CK = BK / TX;   // tile columns per thread
static_assert(BQ == BK, "the tiles share one thread layout");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S) scratch: D_i, written by kernel 1
  void* dq;
  void* dk;
  void* dv;
  int B, S, T, H, KV;
  float scale;
  float softcap;  // <= 0: no softcap
  int causal;
  int window;     // <= 0: no window
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + rows) x D of a (., D) matrix with row stride `stride`
// into fp32 shared memory with rows of D + 1; rows at or past `limit` are 0.
template <typename Tin, int D>
__device__ __forceinline__ void load_rows(float* dst, const Tin* src,
                                          long long stride, int row0,
                                          int rows, int limit) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i % D;
    const int t = row0 + r;
    dst[r * (D + 1) + c] = t < limit ? ld(src + t * stride + c) : 0.f;
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
template <typename Tin, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
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
  const Tin* qb = static_cast<const Tin*>(p.q) + q_off;
  const Tin* ob = static_cast<const Tin*>(p.o) + q_off;
  const Tin* dob = static_cast<const Tin*>(p.dout) + q_off;
  const Tin* kb = static_cast<const Tin*>(p.k) + kv_off;
  const Tin* vb = static_cast<const Tin*>(p.v) + kv_off;
  Tin* dqb = static_cast<Tin*>(p.dq) + q_off;
  const long long row_off = ((long long)b * p.H + h) * p.S;

  load_rows<Tin, D>(Qs, qb, q_row, q0, BQ, p.S);
  load_rows<Tin, D>(dOs, dob, q_row, q0, BQ, p.S);
  load_rows<Tin, D>(Ks, ob, q_row, q0, BQ, p.S);  // O, for D_i
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
    load_rows<Tin, D>(Ks, kb, kv_row, k0, BK, p.T);
    load_rows<Tin, D>(Vs, vb, kv_row, k0, BK, p.T);
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
      st(dqb + s * q_row + tx + TX * c, acc[i][c] * p.scale);
  }
}

// 2. dK and dV: one block a (b, KV head, 64-key tile), summing over the
// query heads of its group.  Runs after kernel 1 (D_i).
template <typename Tin, int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_kernel(const Params p) {
  constexpr int DC = D / TX;
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
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = p.H / p.KV;
  const long long q_row = (long long)p.H * D;
  const long long kv_row = (long long)p.KV * D;
  const long long kv_off = (long long)b * p.T * kv_row + (long long)kvh * D;
  const Tin* kb = static_cast<const Tin*>(p.k) + kv_off;
  const Tin* vb = static_cast<const Tin*>(p.v) + kv_off;
  Tin* dkb = static_cast<Tin*>(p.dk) + kv_off;
  Tin* dvb = static_cast<Tin*>(p.dv) + kv_off;

  load_rows<Tin, D>(Ks, kb, kv_row, k0, BK, p.T);
  load_rows<Tin, D>(Vs, vb, kv_row, k0, BK, p.T);

  // this thread's cells of dK and dV: keys ty + TY a, columns tx + TX c
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
    const Tin* qb = static_cast<const Tin*>(p.q) + q_off;
    const Tin* dob = static_cast<const Tin*>(p.dout) + q_off;
    const long long row_off = ((long long)b * p.H + h) * p.S;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // last tile's Q/dO/P/dS reads finished
      load_rows<Tin, D>(Qs, qb, q_row, q0, BQ, p.S);
      load_rows<Tin, D>(dOs, dob, q_row, q0, BQ, p.S);
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
          const float qv = Qs[i * (D + 1) + tx + TX * c];
          const float dov = dOs[i * (D + 1) + tx + TX * c];
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
      st(dkb + t * kv_row + tx + TX * c, dk[a][c] * p.scale);
      st(dvb + t * kv_row + tx + TX * c, dv[a][c]);
    }
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

template <typename Tin, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int nq = (p.S + BQ - 1) / BQ;
  const int nk = (p.T + BK - 1) / BK;
  cudaError_t err = launch_with(flash_bwd_dq_kernel<Tin, D>, dq_smem_bytes<D>(),
                                dim3(nq, p.H, p.B), p, stream);
  if (err != cudaSuccess) return err;
  return launch_with(flash_bwd_dkv_kernel<Tin, D>, dkv_smem_bytes<D>(),
                     dim3(nk, p.KV, p.B), p, stream);
}

template <typename Tin>
cudaError_t launch_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<Tin, 16>(p, stream);
    case 32: return launch<Tin, 32>(p, stream);
    case 64: return launch<Tin, 64>(p, stream);
    case 128: return launch<Tin, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the first failing launch's cudaGetLastError() (0 on success).  The
// caller has checked shapes, dtype and contiguity (q, o, dout, dq: (B,S,H,D);
// k, v, dk, dv: (B,T,KV,D); lse and delta: float32 (B,H,S)); dtype 0 is
// float32, 1 is bfloat16.  delta is scratch the two kernels share.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int S, int T,
                                   int H, int KV, int D, int dtype,
                                   float scale, float softcap, int causal,
                                   int window, void* stream) {
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T, H, KV,
           scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(launch_dim<float>(p, D, st));
  if (dtype == 1) return static_cast<int>(launch_dim<__nv_bfloat16>(p, D, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
