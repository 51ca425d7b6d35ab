// Forward flash attention for Hopper (sm_90a), fp32 and bf16 in, fp32 math.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel (called by
// flash_attention() there): softmax(mask(softcap(scale * Q K^T))) V with an
// online softmax (running max m, normaliser l clamped at 1e-30, fp32
// accumulator), masks kpos < T, causal qpos >= kpos with qpos = q_pos0 + row,
// and window qpos - kpos < window; GQA maps query head h to KV head
// h / (H / KV).  Layout: q, o (B,S,H,D) and k, v (B,T,KV,D), contiguous.
//
// Design.  The TPU grid (B, H, S/bq, T/bk) ran its KV axis in order on one
// core, carrying m/l/acc in VMEM from step to step.  Blocks of a GPU run in
// no order, so here one block owns one (b, h, 64-row query tile) and walks
// the KV axis in a loop of its own:
//   * the query tile (pre-scaled in fp32) and each 64-key K/V tile are
//     staged in shared memory as fp32; K rows are padded to D+1 floats so
//     that lanes reading different keys hit different banks;
//   * 128 threads as a 16 x 8 grid: each thread owns 4 query rows x 8 keys
//     of the score tile and 4 rows x D/8 columns of the accumulator, all in
//     registers; a row's 8 owners are 8 neighbouring lanes, so its max and
//     sum are three xor-shuffles;
//   * P goes through shared memory to the P.V product;
//   * KV tiles that are masked for every row of the query tile (beyond the
//     causal diagonal, or before the window) are skipped, which is
//     equivalent: a row's first real key resets it through
//     corr = exp(-1e30 - m) = 0, exactly as in the reference.
// Masked logits are the finite -1e30, never -inf: exp(-inf - -inf) is NaN.
//
// What bounds it on an H100.  At the jag-surrogate prefill shape
// (B=4, S=T=512, H=4, D=64, bf16, causal) the work is 0.54 GFLOP over 4 MiB of
// q/k/v/o: the card's floor is the memory term (about 1.3 us at 3.35 TB/s)
// at short S, and the tensor-core term (989 TFLOP/s bf16) once S passes a
// few thousand.  This kernel reaches neither: its products are scalar fp32
// FMAs on the CUDA cores (67 TFLOP/s peak), each tile is loaded by the
// threads themselves with no copy/compute overlap, and only B*H*S/64 blocks
// are launched (128 at the jag shape, under one per SM).  Left on the table
// for later work: wgmma on bf16 tiles from shared memory, TMA loads into a
// multi-stage ring with mbarriers, warp specialisation, and splitting the KV
// axis across blocks when B*H*S/64 cannot fill 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int TY = 16;        // thread grid rows
constexpr int TX = 8;         // thread grid columns (one row's owners)
constexpr int NT = TY * TX;   // threads per block
constexpr int RQ = BQ / TY;   // query rows per thread
constexpr int CK = BK / TX;   // keys per thread
constexpr float NEG_INF = -1e30f;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, H, KV;
  float scale;
  float softcap;  // <= 0: no softcap
  int causal;
  int window;     // <= 0: no window
  int q_pos0;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  static_assert(D % TX == 0, "head dim must split over the thread columns");
  constexpr int DC = D / TX;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x (D+1), pre-scaled
  float* Ks = Qs + BQ * (D + 1);     // BK x (D+1)
  float* Vs = Ks + BK * (D + 1);     // BK x D
  float* Ps = Vs + BK * D;           // BQ x (BK+1)

  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  const long long q_row = (long long)p.H * D;    // stride of s in q and o
  const long long kv_row = (long long)p.KV * D;  // stride of t in k and v
  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.S * q_row +
                (long long)h * D;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.T * kv_row +
                (long long)kvh * D;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.T * kv_row +
                (long long)kvh * D;
  T* ob = static_cast<T*>(p.o) + (long long)b * p.S * q_row + (long long)h * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    Qs[r * (D + 1) + c] = s < p.S ? to_f32(qb[s * q_row + c]) * p.scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // KV range that can hold a real key for some row of this tile.
  const int q_last = min(q0 + BQ, p.S) - 1;
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, p.q_pos0 + q_last + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, p.q_pos0 + q0 - p.window + 1);

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Qs written; last tile's Ks/Vs/Ps reads finished
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      const bool in = t < p.T;
      Ks[r * (D + 1) + c] = in ? to_f32(kb[t * kv_row + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[t * kv_row + c]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + TX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty + TY * i;
      const int qpos = p.q_pos0 + q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k0 + tx + TX * j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool keep = kpos < p.T;
        if (p.causal) keep = keep && qpos >= kpos;
        if (p.window > 0) keep = keep && (qpos - kpos) < p.window;
        x = keep ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[row * (BK + 1) + tx + TX * j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + TY * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[kk * D + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q0 + ty + TY * i;
    if (s >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[s * q_row + tx + TX * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success).  The caller has
// checked shapes, dtype and contiguity; dtype 0 is float32, 1 is bfloat16.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int T, int H, int KV,
                                   int D, int dtype, float scale,
                                   float softcap, int causal, int window,
                                   int q_pos0, void* stream) {
  Params p{q, k, v, o, B, S, T, H, KV, scale, softcap, causal, window, q_pos0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(p, D, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(p, D, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
