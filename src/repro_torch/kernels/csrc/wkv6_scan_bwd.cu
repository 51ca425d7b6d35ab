// RWKV6 (Finch) WKV scan backward for Hopper (sm_90a): dr, dk, dv, dw, du
// of the function csrc/wkv6_scan.cu computes, on scalar fp32 FMAs; r, k, v
// and dy float32 or bfloat16 (one dtype), w and u float32; dr, dk, dv in
// r's dtype, dw and du float32.
//
// The TPU kernel repro/kernels/wkv6_scan.py:_kernel computes the forward
// only, and the reference has no VJP for it (it differentiates its plain
// chunked path with jax.grad).  This kernel is that gradient for the port.
// With wc = clip(w, 1e-12, 1) and the state S_t (D x D, fp32) entering step
// t of one (b, h), S_0 = 0:
//   y_t     = r_t^T S_t + (r_t . u . k_t) v_t
//   S_{t+1} = diag(wc_t) S_t + k_t v_t^T
// and G_t = dL/dS_t, G_S = 0, walked back in time:
//   G_t     = diag(wc_t) G_{t+1} + r_t dy_t^T
//   dr_t    = S_t dy_t + u k_t (v_t . dy_t)
//   dk_t    = G_{t+1} v_t + r_t u (v_t . dy_t)
//   dv_t    = G_{t+1}^T k_t + (r_t . u . k_t) dy_t
//   dw_t[d] = sum_e G_{t+1}[d,e] S_t[d,e], where w_t[d] lies in
//             [1e-12, 1] (torch.clamp's gradient; 0 where the clip cuts)
//   du      = sum over b, t of r_t k_t (v_t . dy_t)
// dw is taken from the states themselves: no decay is ever inverted (a
// division by wc near the clip, log 1e-12 = -27.6 a step, overflows), and
// no difference of long sums cancels.
//
// Design.  One block a (b, h), 4 D threads: thread i owns row i / 4 of S
// and of G and the D / 4 columns from (i % 4) D / 4 on, in registers.  A
// row's sums (dr, dk, dw, v . dy) are 4-lane shuffles; dv's column sums
// are shuffles over the 8 rows of a warp, then the warps' partial rows in
// shared memory, added by D threads in warp order.
//   1. Forward in time from S = 0: dr_t, and the state entering every
//      chunk of CHUNK = 64 steps written to the checkpoint scratch (B, H,
//      ceil(S / CHUNK), D, D): 4 D^2 / CHUNK bytes a step of each (b, h),
//      2x r's bf16 bytes at D 64.
//   2. Backward over the chunks from the last, in two levels: the states
//      entering the chunk's segments of HT = 16384 / D^2 steps are
//      recomputed from the chunk's checkpoint into the block's own scratch
//      (CHUNK / HT states, 256 KB at D 64); then, segment by segment from
//      the last, the segment's states are recomputed from its entry state
//      into shared memory (HT x D x D floats, 64 KB) and walked back in
//      time with G.  Three forward passes over time in all, for scratch
//      of O(S D^2 / CHUNK) rather than O(S D^2 / HT).
//   3. du: each block writes its (b, h) row of du partial sums; a second
//      kernel adds them over b in a fixed order.  No atomics: the result
//      does not depend on the order in which blocks run.
// Every sum runs in fp32 (bf16 inputs are widened on load), so the kernel
// holds the sequential oracle's float32 gradient (ref.wkv6_scan_ref under
// autograd) at rounding level; ref.wkv6_scan_bwd_ref is its plain version.
//
// What bounds it on an H100.  At rwkv6-3b's training shape (B 8, S 128,
// H 40, D 64, bf16) the bytes (r, k, v, dy, dr, dk, dv in bf16, w and dw in
// fp32, each once: 58 MB) need 17 us at 3.35 TB/s; the work is 12 D^2
// flops a step of each (b, h), 2.0 GFLOP, 2 us at the tensor cores' 989
// TFLOP/s.  The kernel is bound by the
// latency of its sequential walk (three passes over time, two block
// barriers a step of the last) with 320 blocks of 256 threads, 3 an
// SM: far above both bounds.  Later work: the chunked form on the tensor
// cores (the forward's design) for the products within a segment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float W_MIN = 1e-12f;
constexpr int HIST_FLOATS = 16384;  // the recomputed segment: 64 KB
constexpr int CHUNK = 64;           // steps between the saved states

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
  const void* dy;
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* du_part;  // (B, H, D) scratch
  float* ckpt;     // (B, H, ceil(S / CHUNK), D, D) scratch
  float* seg;      // (B, H, CHUNK / HT, D, D) scratch
  int B, S, H;
};

template <int D>
struct Layout {
  static constexpr int NTH = 4 * D;  // threads a block
  static constexpr int NC = D / 4;   // columns a thread
  static constexpr int NW = NTH / 32;
  static constexpr int HT = HIST_FLOATS / (D * D);  // steps a segment
  static constexpr int NSEG = CHUNK / HT;            // segments a chunk
  static_assert(CHUNK % HT == 0, "a chunk holds whole segments");
  static constexpr size_t smem = sizeof(float) * (HIST_FLOATS + NW * D);
};

__device__ __forceinline__ float row_sum(float x) {  // over a row's 4 lanes
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int NC>
__device__ __forceinline__ void load_cols(const T* src, float (&o)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) o[j] = to_f32(src[j]);
}

template <typename T, int D>
__global__ void __launch_bounds__(4 * D) wkv6_bwd_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int NTH = L::NTH, NC = L::NC, NW = L::NW, HT = L::HT;
  constexpr int NSEG = L::NSEG;
  extern __shared__ float smem[];
  float* hist = smem;               // HT states, element (j, tid) of step s
  float* red = hist + HIST_FLOATS;  // NW x D partial column sums

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row = tid / 4, c0 = (tid % 4) * NC;
  const int bh = blockIdx.x;  // b H + h
  const int b = bh / p.H, h = bh % p.H;
  const long long ts = (long long)p.H * D;  // time stride
  const long long base = (long long)b * p.S * ts + (long long)h * D;
  const T* r = static_cast<const T*>(p.r) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const T* dy = static_cast<const T*>(p.dy) + base;
  const float* w = p.w + base;
  T* dr = static_cast<T*>(p.dr) + base;
  T* dk = static_cast<T*>(p.dk) + base;
  T* dv = static_cast<T*>(p.dv) + base;
  float* dw = p.dw + base;
  const int nch = (p.S + CHUNK - 1) / CHUNK;
  // each thread reads back only the elements it wrote: no barrier needed
  float* ck = p.ckpt + (long long)bh * nch * D * D + row * D + c0;
  float* sg = p.seg + (long long)bh * NSEG * D * D + row * D + c0;
  const float ud = p.u[h * D + row];

  // 1. forward: dr, and the state entering each chunk
  float st[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) st[j] = 0.f;
  for (int t = 0; t < p.S; ++t) {
    const long long o = t * ts;
    if (t % CHUNK == 0) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        ck[(long long)(t / CHUNK) * D * D + j] = st[j];
    }
    const float kd = to_f32(k[o + row]);
    const float wd = fminf(fmaxf(w[o + row], W_MIN), 1.f);
    float vv[NC], yy[NC];
    load_cols<T, NC>(v + o + c0, vv);
    load_cols<T, NC>(dy + o + c0, yy);
    float a = 0.f, vy = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      a = fmaf(st[j], yy[j], a);
      vy = fmaf(vv[j], yy[j], vy);
      st[j] = fmaf(wd, st[j], kd * vv[j]);
    }
    a = row_sum(a);
    vy = row_sum(vy);
    if (tid % 4 == 0) dr[o + row] = from_f32<T>(a + ud * kd * vy);
  }

  // 2. backward over the chunks, then their segments; g = G_{t+1}
  float g[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) g[j] = 0.f;
  float du_acc = 0.f;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int c0t = ch * CHUNK, c1t = min(p.S, c0t + CHUNK);
    const int nseg = (c1t - c0t + HT - 1) / HT;
    // the state entering each segment of the chunk
#pragma unroll
    for (int j = 0; j < NC; ++j) st[j] = ck[(long long)ch * D * D + j];
    for (int t = c0t;; ++t) {
      if ((t - c0t) % HT == 0) {
#pragma unroll
        for (int j = 0; j < NC; ++j)
          sg[(long long)((t - c0t) / HT) * D * D + j] = st[j];
      }
      if (t == c0t + (nseg - 1) * HT) break;
      const long long o = t * ts;
      const float kd = to_f32(k[o + row]);
      const float wd = fminf(fmaxf(w[o + row], W_MIN), 1.f);
      float vv[NC];
      load_cols<T, NC>(v + o + c0, vv);
#pragma unroll
      for (int j = 0; j < NC; ++j) st[j] = fmaf(wd, st[j], kd * vv[j]);
    }
    for (int seg = nseg - 1; seg >= 0; --seg) {
      const int t0 = c0t + seg * HT, t1 = min(c1t, t0 + HT);
#pragma unroll
      for (int j = 0; j < NC; ++j) st[j] = sg[(long long)seg * D * D + j];
      for (int t = t0; t < t1; ++t) {  // hist[t - t0] = S_t
        float* hs = hist + (t - t0) * NC * NTH + tid;
#pragma unroll
        for (int j = 0; j < NC; ++j) hs[j * NTH] = st[j];
        if (t + 1 == t1) break;
        const long long o = t * ts;
        const float kd = to_f32(k[o + row]);
        const float wd = fminf(fmaxf(w[o + row], W_MIN), 1.f);
        float vv[NC];
        load_cols<T, NC>(v + o + c0, vv);
#pragma unroll
        for (int j = 0; j < NC; ++j) st[j] = fmaf(wd, st[j], kd * vv[j]);
      }
      for (int t = t1 - 1; t >= t0; --t) {
        const long long o = t * ts;
        const float rd = to_f32(r[o + row]);
        const float kd = to_f32(k[o + row]);
        const float wr = w[o + row];
        const float wd = fminf(fmaxf(wr, W_MIN), 1.f);
        float vv[NC], yy[NC];
        load_cols<T, NC>(v + o + c0, vv);
        load_cols<T, NC>(dy + o + c0, yy);
        const float* hs = hist + (t - t0) * NC * NTH + tid;
        float vy = 0.f, gv = 0.f, gs = 0.f;
        float cp[NC];
        const float ru = rd * ud;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          vy = fmaf(vv[j], yy[j], vy);
          gv = fmaf(g[j], vv[j], gv);
          gs = fmaf(g[j], hs[j * NTH], gs);
          cp[j] = kd * fmaf(ru, yy[j], g[j]);
          g[j] = fmaf(wd, g[j], rd * yy[j]);  // now G_t
        }
        vy = row_sum(vy);
        gv = row_sum(gv);
        gs = row_sum(gs);
        if (tid % 4 == 0) {
          dk[o + row] = from_f32<T>(gv + ru * vy);
          dw[o + row] = (wr >= W_MIN && wr <= 1.f) ? gs : 0.f;
        }
        du_acc = fmaf(rd * kd, vy, du_acc);
        // dv: the column sums of cp over the D rows
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          cp[j] += __shfl_xor_sync(0xffffffffu, cp[j], 4);
          cp[j] += __shfl_xor_sync(0xffffffffu, cp[j], 8);
          cp[j] += __shfl_xor_sync(0xffffffffu, cp[j], 16);
        }
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < NC; ++j) red[warp * D + c0 + j] = cp[j];
        }
        __syncthreads();
        if (tid < D) {
          float s = 0.f;
#pragma unroll
          for (int ww = 0; ww < NW; ++ww) s += red[ww * D + tid];
          dv[o + tid] = from_f32<T>(s);
        }
        __syncthreads();  // red is read before the next step writes it
      }
    }
  }
  if (tid % 4 == 0) p.du_part[(long long)bh * D + row] = du_acc;
}

// out[i] = sum_j part[j * n + i] over j < m, in order: du over b.
__global__ void sum_rows_kernel(const float* part, float* out, int m, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < m; ++j) s += part[(long long)j * n + i];
  out[i] = s;
}

template <typename T, int D>
cudaError_t launch(const Params& p, float* du, cudaStream_t stream) {
  using L = Layout<D>;
  auto kernel = wkv6_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.B * p.H, L::NTH, L::smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = p.H * D;
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, stream>>>(p.du_part, du, p.B, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, float* du, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(p, du, st);
    case 32: return launch<T, 32>(p, du, st);
    case 64: return launch<T, 64>(p, du, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The scratch the wrapper allocates: ckpt B H ceil(S / 64) D^2 floats, seg
// B H (64 D^2 / 16384) D^2 and du_part B H D.  Every tensor is contiguous:
// r, k, v, w, dy, dr, dk, dv, dw (B, S, H, D); u, du (H, D).  dtype 0 is
// float32, 1 is bfloat16 (r, k, v, dy, dr, dk, dv).  Returns the first
// failing launch's cudaGetLastError() (0 on success).
extern "C" int wkv6_scan_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* dy,
                             void* dr, void* dk, void* dv, void* dw, void* du,
                             void* du_part, void* ckpt, void* seg, int B,
                             int S, int H, int D, int dtype, void* stream) {
  Params p{r, k, v, static_cast<const float*>(w),
           static_cast<const float*>(u), dy, dr, dk, dv,
           static_cast<float*>(dw), static_cast<float*>(du_part),
           static_cast<float*>(ckpt), static_cast<float*>(seg), B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* duf = static_cast<float*>(du);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(p, D, duf, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(p, D, duf, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* wkv6_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
