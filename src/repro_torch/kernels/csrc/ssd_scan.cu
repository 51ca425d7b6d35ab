// Mamba2 SSD scan for Hopper (sm_90a): fp32 or bf16 x/B/C, fp32 dt and A,
// fp32 math, output in x's dtype.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:_kernel (called by
// ssd_scan() there).  Per (b, h), with acs = cumsum(A dt) over a tile of time
// and a (P, N) fp32 state h carried from tile to tile:
//   W[t,s]  = (C_t . B_s) exp(acs_t - acs_s) dt_s                 (s <= t)
//   y[t,:]  = W[t,:] . x + exp(acs_t) (C_t . h^T)
//   h      <- exp(acs_L) h + (x * (exp(acs_L - acs) dt))^T B
// A < 0 and dt > 0, so acs falls along time and exp(acs_t - acs_s) is only
// evaluated for t >= s, where the exponent is <= 0: nothing overflows.
// Layout: x, y (B,S,H,P); dt (B,S,H); A (H,); B, C (B,S,N), shared by heads;
// contiguous.
//
// Design.  The Pallas grid (B, H, S/chunk) ran its chunk axis in order on
// one core, carrying h in VMEM, with chunk x chunk tiles on the MXU.  Here
// one block owns one (b, h) and walks the time axis in a loop of its own:
//   * the kernel's tile is 64 rows, whatever the wrapper's `chunk` (the
//     padding unit): zamba2's chunk of 256 would need a 256 x 256 fp32 (t,s)
//     tile, 256 KB, more than an SM's 227 KB.  Chunking is exact, so the
//     result equals the chunked algorithm (ref.ssd_chunked_ref) at any
//     chunk up to rounding.  A ragged last tile (S = 200 is 3 x 64 + 8) is
//     cut to the rows that exist;
//   * x, B, C, W, the state and the cumsum live in shared memory as fp32
//     (about 83 KB at P = N = 64); B's and h's rows are padded to N+1
//     floats where lanes read along the row index;
//   * the cumsum of A dt over a tile is one warp's shuffle scan;
//   * 256 threads; products are scalar fp32 FMAs on the CUDA cores.
//
// What bounds it on an H100.  At zamba2's prefill (B=4, S=512, H=64, P=N=64,
// bf16) the bytes (x and y in bf16, dt in fp32, B and C in bf16 read once)
// are about 34.6 MB, 10.3 us at 3.35 TB/s; the products (C B^T, W x, C h^T,
// the state update: about 2.3 GFLOP here) need 2.3 us even on the tensor
// cores, so the card's floor is the memory.  This kernel reaches neither:
// its products are scalar fp32 FMAs (67 TFLOP/s peak, so about 35 us of
// FMAs at best), tiles are loaded by the threads with no copy/compute
// overlap, and B*H = 256 blocks of 256 threads leave most warps of an SM
// waiting on shared memory.  C B^T is the same for all heads and is
// recomputed per head.  Left for later work: wgmma on bf16 tiles, C B^T
// computed once per (b, tile) and shared by the heads (or several heads per
// block), and TMA loads of the next tile while this one computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;    // time rows per tile
constexpr int NT = 256;  // threads per block

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
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  int B, S, H;
};

template <int P, int N>
constexpr size_t smem_bytes() {
  // x; B padded; C; h padded; W; dt, acs, tail
  return sizeof(float) *
         (L * P + L * (N + 1) + L * N + P * (N + 1) + L * L + 3 * L);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT) ssd_kernel(const Params p) {
  constexpr int NP = N + 1;         // padded row
  constexpr int GY = NT / P;        // row groups of the y product
  constexpr int GH = NT / N;        // row groups of the state update
  static_assert(NT % P == 0 && NT % N == 0 && L % GY == 0 && P % GH == 0,
                "thread split");
  extern __shared__ float smem[];
  float* xs = smem;                 // L x P
  float* bs = xs + L * P;           // L x NP
  float* cs = bs + L * NP;          // L x N
  float* hs = cs + L * N;           // P x NP state
  float* ws = hs + P * NP;          // L x L
  float* dts = ws + L * L;          // L: dt
  float* acs = dts + L;             // L: cumsum of A dt
  float* tails = acs + L;           // L: exp(acs_last - acs) dt

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a_h = p.A[h];
  const long long xrow = (long long)p.H * P;  // stride of s in x and y
  const T* xg = static_cast<const T*>(p.x) + (long long)b * p.S * xrow +
                (long long)h * P;
  T* yg = static_cast<T*>(p.y) + (long long)b * p.S * xrow + (long long)h * P;
  const float* dtg = p.dt + (long long)b * p.S * p.H + h;
  const T* bg = static_cast<const T*>(p.Bm) + (long long)b * p.S * N;
  const T* cg = static_cast<const T*>(p.Cm) + (long long)b * p.S * N;

  for (int i = tid; i < P * NP; i += NT) hs[i] = 0.f;

  const int py = tid % P, gy = tid / P;  // y product: column, row group
  const int nh = tid % N, gh = tid / N;  // state update: column, row group

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int n = min(L, p.S - t0);  // rows in this tile
    __syncthreads();  // last tile's reads of the tile buffers are done
    for (int i = tid; i < n * P; i += NT) {
      const int t = i / P, c = i % P;
      xs[i] = to_f32(xg[(long long)(t0 + t) * xrow + c]);
    }
    for (int i = tid; i < n * N; i += NT) {
      const int t = i / N, c = i % N;
      const long long off = (long long)(t0 + t) * N + c;
      bs[t * NP + c] = to_f32(bg[off]);
      cs[i] = to_f32(cg[off]);
    }
    if (tid < 32) {  // one warp: dt and the inclusive cumsum of A dt
      const int t1 = 2 * tid, t2 = t1 + 1;
      const float d1 = t1 < n ? dtg[(long long)(t0 + t1) * p.H] : 0.f;
      const float d2 = t2 < n ? dtg[(long long)(t0 + t2) * p.H] : 0.f;
      const float a1 = a_h * d1, a2 = a_h * d2;
      float run = a1 + a2;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += o;
      }
      const float before = run - (a1 + a2);  // sum over rows < t1
      dts[t1] = d1;
      dts[t2] = d2;
      acs[t1] = before + a1;
      acs[t2] = before + a1 + a2;
    }
    __syncthreads();
    const float acs_last = acs[n - 1];
    // W[t,s] = (C_t . B_s) exp(acs_t - acs_s) dt_s for s <= t; the tail
    // weights of the state update
    for (int i = tid; i < n * n; i += NT) {
      const int t = i / n, s = i % n;
      float wv = 0.f;
      if (s <= t) {
        float cb = 0.f;
#pragma unroll 8
        for (int c = 0; c < N; ++c) cb = fmaf(cs[t * N + c], bs[s * NP + c], cb);
        wv = cb * expf(acs[t] - acs[s]) * dts[s];
      }
      ws[t * L + s] = wv;
    }
    for (int s = tid; s < n; s += NT) tails[s] = expf(acs_last - acs[s]) * dts[s];
    __syncthreads();
    // y[t,p] = sum_{s<=t} W[t,s] x[s,p] + exp(acs_t) sum_c C[t,c] h[p,c]
#pragma unroll
    for (int j = 0; j < L / GY; ++j) {
      const int t = gy + GY * j;
      if (t >= n) break;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra = fmaf(ws[t * L + s], xs[s * P + py], intra);
      float ch = 0.f;
#pragma unroll 8
      for (int c = 0; c < N; ++c) ch = fmaf(cs[t * N + c], hs[py * NP + c], ch);
      yg[(long long)(t0 + t) * xrow + py] =
          from_f32<T>(intra + expf(acs[t]) * ch);
    }
    __syncthreads();  // every read of h is done before it changes
    // h[p,c] <- exp(acs_last) h[p,c] + sum_s x[s,p] tail[s] B[s,c]
    const float decay = expf(acs_last);
#pragma unroll
    for (int j = 0; j < P / GH; ++j) {
      const int pp = gh + GH * j;
      float g = 0.f;
      for (int s = 0; s < n; ++s)
        g = fmaf(xs[s * P + pp] * tails[s], bs[s * NP + nh], g);
      hs[pp * NP + nh] = hs[pp * NP + nh] * decay + g;
    }
  }
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_kernel<T, P, N><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const Params& p, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, P, 16>(p, stream);
    case 32: return launch<T, P, 32>(p, stream);
    case 64: return launch<T, P, 64>(p, stream);
    case 128: return launch<T, P, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_p(const Params& p, int P, int N, cudaStream_t stream) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(p, N, stream);
    case 32: return dispatch_n<T, 32>(p, N, stream);
    case 64: return dispatch_n<T, 64>(p, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success).  The caller has
// checked shapes, dtypes and contiguity; dtype 0 is float32, 1 is bfloat16
// (of x, B, C and y; dt and A are float32).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, int B,
                            int S, int H, int P, int N, int dtype,
                            void* stream) {
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, y, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_p<float>(p, P, N, st);
  else if (dtype == 1)
    err = dispatch_p<__nv_bfloat16>(p, P, N, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
