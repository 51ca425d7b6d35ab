// RWKV6 (Finch) WKV scan for Hopper (sm_90a): fp32 or bf16 r/k/v, fp32 w and
// u, fp32 math, output in r's dtype.
//
// Replaces the TPU kernel repro/kernels/wkv6_scan.py:_kernel (called by
// wkv6_scan() there).  Per (b, h), with lw = log(clip(w, 1e-12, 1)), the
// exclusive / inclusive cumsums ecl / cl of lw over a tile of time, and a
// (D, D) fp32 state S carried from tile to tile:
//   att[t,s] = sum_d r[t,d] exp(ecl[t,d] - cl[s,d]) k[s,d]      (s < t)
//   att[t,t] = sum_d r[t,d] u[d] k[t,d]                          (the bonus)
//   y[t,:]   = att[t,:] . v + (r[t,:] * exp(ecl[t,:])) . S
//   S       <- diag(exp(cl[L-1,:])) S + (k * exp(cl[L-1,:] - cl))^T v
// Every exponent is <= 0 (lw <= 0 and cl is non-increasing), so nothing
// overflows.  Layout: r, k, v, w, y (B,S,H,D), u (H,D), contiguous.
//
// Design.  The Pallas grid (B, H, S/chunk) ran its chunk axis in order on
// one core, carrying S in VMEM.  Blocks of a GPU run in no order, so here one
// block owns one (b, h) and walks the time axis in 64-row tiles itself:
//   * the log and the clip are fused: the block reads w and writes lw to
//     shared memory, so no lw array goes through device memory;
//   * r, k, v, the cumsums, S and att live in shared memory as fp32 (about
//     113 KB at D = 64, so the launch raises the dynamic shared-memory
//     limit); rows read by lanes that differ in the row index are padded to
//     D+1 floats so that the lanes hit different banks;
//   * the 64-row tile is the kernel's own unit: the wrapper's `chunk` only
//     pads S.  Chunking is exact, so the result equals the chunked algorithm
//     (ref.wkv6_chunked_ref) at any chunk up to rounding.  A ragged last
//     tile is cut to the rows that exist;
//   * 256 threads; products are scalar fp32 FMAs on the CUDA cores.
//
// What bounds it on an H100.  The pairwise form takes L*(L-1)/2*D
// exponentials a tile: at rwkv6-3b's prefill (B=4, S=512, H=40, D=64) about
// 1.7e8, on the special-function units (16 a clock per SM, about 3.6e12/s
// over the card), about 46 us, while the bytes (r, k, v, y in bf16, w in
// fp32: 63 MB) need 19 us at 3.35 TB/s and the products are far below the
// tensor cores' rate.  So this kernel is bound by its exponentials, and its
// B*H = 160 blocks fill 132 SMs only once.  Left for later work: the factored
// form of ref.wkv6_blocked_ref (exponentials per (t, d) and per sub-block,
// products on the tensor cores with wgmma), splitting the state's columns
// (the e axis) across blocks to fill the card, and TMA loads of the next tile
// while this one computes.

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
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* y;
  int B, S, H;
};

template <int D>
constexpr size_t smem_bytes() {
  // r, k, ecl, cl padded; v; S; att; u
  return sizeof(float) * (4 * L * (D + 1) + L * D + D * D + L * L + D);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) wkv6_kernel(const Params p) {
  constexpr int DP = D + 1;       // padded row
  constexpr int NG = NT / D;      // thread groups over rows
  constexpr int RY = L / NG;      // output rows per thread
  constexpr int RS = D / NG;      // state rows per thread
  static_assert(NT % D == 0 && L % NG == 0 && D % NG == 0, "thread split");
  extern __shared__ float smem[];
  float* rs = smem;               // L x DP: r, then r * exp(ecl)
  float* ks = rs + L * DP;        // L x DP: k, then k * exp(cl_last - cl)
  float* es = ks + L * DP;        // L x DP: ecl
  float* cs = es + L * DP;        // L x DP: lw, then cl
  float* vs = cs + L * DP;        // L x D
  float* st = vs + L * D;         // D x D state
  float* at = st + D * D;         // L x L att
  float* us = at + L * L;         // D

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long row = (long long)p.H * D;  // stride of s
  const long long base = (long long)b * p.S * row + (long long)h * D;
  const T* rg = static_cast<const T*>(p.r) + base;
  const T* kg = static_cast<const T*>(p.k) + base;
  const T* vg = static_cast<const T*>(p.v) + base;
  const float* wg = p.w + base;
  T* yg = static_cast<T*>(p.y) + base;

  for (int i = tid; i < D * D; i += NT) st[i] = 0.f;
  for (int i = tid; i < D; i += NT) us[i] = p.u[h * D + i];

  const int e = tid % D;   // column owned in the y and state products
  const int g = tid / D;   // row group

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int n = min(L, p.S - t0);  // rows in this tile
    __syncthreads();  // last tile's reads of the tile buffers are done
    for (int i = tid; i < n * D; i += NT) {
      const int t = i / D, d = i % D;
      const long long off = (long long)(t0 + t) * row + d;
      rs[t * DP + d] = to_f32(rg[off]);
      ks[t * DP + d] = to_f32(kg[off]);
      vs[t * D + d] = to_f32(vg[off]);
      cs[t * DP + d] = logf(fminf(fmaxf(wg[off], 1e-12f), 1.f));
    }
    __syncthreads();
    // per-channel cumsums over the tile: exclusive (ecl) and inclusive (cl)
    if (tid < D) {
      float c = 0.f;
      for (int t = 0; t < n; ++t) {
        const float lw = cs[t * DP + tid];
        es[t * DP + tid] = c;
        c += lw;
        cs[t * DP + tid] = c;
      }
    }
    __syncthreads();
    // att[t,s]: pairwise decayed r.k for s < t, the bonus on the diagonal
    for (int i = tid; i < n * n; i += NT) {
      const int t = i / n, s = i % n;
      float a = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          a = fmaf(rs[t * DP + d] * expf(es[t * DP + d] - cs[s * DP + d]),
                   ks[s * DP + d], a);
      } else if (s == t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          a = fmaf(rs[t * DP + d] * us[d], ks[t * DP + d], a);
      }
      at[t * L + s] = a;
    }
    __syncthreads();
    // r <- r * exp(ecl), k <- k * exp(cl_last - cl)
    for (int i = tid; i < n * D; i += NT) {
      const int t = i / D, d = i % D;
      rs[t * DP + d] *= expf(es[t * DP + d]);
      ks[t * DP + d] *= expf(cs[(n - 1) * DP + d] - cs[t * DP + d]);
    }
    __syncthreads();
    // y[t,e] = sum_{s<=t} att[t,s] v[s,e] + sum_d rexp[t,d] S[d,e]
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      const int t = g + NG * j;
      if (t >= n) break;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc = fmaf(at[t * L + s], vs[s * D + e], acc);
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(rs[t * DP + d], st[d * D + e], acc);
      yg[(long long)(t0 + t) * row + e] = from_f32<T>(acc);
    }
    __syncthreads();  // every read of S is done before it changes
    // S[d,e] <- S[d,e] exp(cl_last[d]) + sum_s ktail[s,d] v[s,e]
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      const int d = g + NG * j;
      float acc = 0.f;
      for (int s = 0; s < n; ++s) acc = fmaf(ks[s * DP + d], vs[s * D + e], acc);
      st[d * D + e] = st[d * D + e] * expf(cs[(n - 1) * DP + d]) + acc;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  wkv6_kernel<T, D><<<grid, NT, smem, stream>>>(p);
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

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success).  The caller has
// checked shapes, dtypes and contiguity; dtype 0 is float32, 1 is bfloat16
// (of r, k, v and y; w and u are float32).
extern "C" int wkv6_scan_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, void* y, int B,
                             int S, int H, int D, int dtype, void* stream) {
  Params p{r, k, v, static_cast<const float*>(w),
           static_cast<const float*>(u), y, B, S, H};
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

extern "C" const char* wkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
