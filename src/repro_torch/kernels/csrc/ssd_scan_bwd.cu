// Mamba2 SSD scan backward for Hopper (sm_90a): dx, ddt, dA, dB, dC of the
// function csrc/ssd_scan.cu computes, on scalar fp32 FMAs; x, B, C and dy
// float32 or bfloat16 (one dtype), dt and A float32; dx in x's dtype, dB
// and dC in B's, ddt and dA float32.
//
// The TPU kernel repro/kernels/ssd_scan.py:_kernel computes the forward
// only, and the reference has no VJP for it (it differentiates its plain
// chunked path with jax.grad).  This kernel is that gradient for the port.
// With a_t = exp(A dt_t) and the state h_t (P x N, fp32) of one (b, h) after
// step t, h_{-1} = 0:
//   h_t  = a_t h_{t-1} + dt_t x_t B_t^T          y_t = h_t C_t
// and Gh_t = dL/dh_t, walked back in time from Gh_{S-1} = dy C^T:
//   Gh_t  = dy_t C_t^T + a_{t+1} Gh_{t+1}
//   dx_t  = dt_t Gh_t B_t
//   dB_t  = sum over heads of dt_t Gh_t^T x_t
//   dC_t  = sum over heads of h_t^T dy_t
//   ddt_t = x_t . Gh_t B_t + A a_t <Gh_t, h_{t-1}>
//   dA    = sum over b, t of dt_t a_t <Gh_t, h_{t-1}>
// No decay is inverted: h_{t-1} is recomputed forward from a checkpoint.
// A padded row (x = 0, dt = 0: a = 1) carries the state through unchanged;
// the wrapper's caller cuts its gradients off (ops pads, F.pad's backward
// drops them).
//
// Design.  One block a (b, h), 4 P threads: thread i owns row i / 4 of h
// and of Gh and the N / 4 columns from (i % 4) N / 4 on, in registers.  A
// row's sums over n are 4-lane shuffles; the column sums over p (dB, dC)
// are shuffles over the 8 rows of a warp, then the warps' partial rows in
// shared memory added by N threads in warp order; the block sums of ddt
// and dA go the same way through thread 0.
//   1. Forward in time from h = 0: each head's dC_t partial row, and the
//      state entering every chunk of CHUNK = 64 steps written to the
//      checkpoint scratch (B, H, ceil(S / CHUNK), P, N): 4 P N / CHUNK
//      bytes a step of each (b, h), 2x x's bf16 bytes at P = N = 64.
//   2. Backward over the chunks from the last, in two levels: the states
//      entering the chunk's segments of HT = 16384 / (P N) steps are
//      recomputed from the chunk's checkpoint into the block's own scratch
//      (CHUNK / HT states, 256 KB at P = N = 64); then, segment by segment
//      from the last, the states entering the segment's steps are
//      recomputed into shared memory (HT x P x N floats, 64 KB) and walked
//      back in time with Gh: dx, ddt, and each head's dB_t partial row.
//   3. B and C are shared by all H heads, and A by every (b, t): dB and dC
//      are written per head into (B, S, H, N) fp32 scratch (2x x's bf16
//      bytes each at N = P) and dA per (b, h) into (B, H); a second kernel
//      adds each over the heads (over b for dA) in a fixed order.  No
//      atomics: the result does not depend on the order in which blocks
//      run.
// Every sum runs in fp32 (bf16 inputs are widened on load), so the kernel
// holds the sequential oracle's float32 gradient (ref.ssd_scan_ref under
// autograd) at rounding level; ref.ssd_scan_bwd_ref is its plain version.
//
// What bounds it on an H100.  At zamba2-1.2b's training shape (B 8, S 128,
// H 64, P 64, N 64, bf16) the bytes (x, dy, dx in bf16, B, C, dB, dC in
// bf16, dt and ddt in fp32, each once: 26 MB) need 7.8 us at 3.35 TB/s;
// the work is 12 P N flops a step of each (b, h), 3.2 GFLOP, 3.3 us at
// the tensor cores' 989 TFLOP/s.  The kernel is bound by the latency of
// its sequential walk (three passes over time, block barriers every step
// of the first and the last) with 512 blocks of 256 threads,
// ~3 an SM, and by the per-head partial rows of dB and dC (8 B S H N
// bytes written and read again).  Later work: the chunked form on the
// tensor cores (the forward's design) within a segment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  void* dx;
  float* ddt;
  float* dA_part;  // (B, H) scratch
  float* dB_part;  // (B, S, H, N) scratch
  float* dC_part;  // (B, S, H, N) scratch
  float* ckpt;     // (B, H, ceil(S / CHUNK), P, N) scratch
  float* seg;      // (B, H, CHUNK / HT, P, N) scratch
  int B, S, H;
};

template <int P, int N>
struct Layout {
  static constexpr int NTH = 4 * P;  // threads a block
  static constexpr int NC = N / 4;   // columns a thread
  static constexpr int NW = NTH / 32;
  static constexpr int HT = HIST_FLOATS / (P * N);  // steps a segment
  static constexpr int NSEG = CHUNK / HT;            // segments a chunk
  static_assert(CHUNK % HT == 0, "a chunk holds whole segments");
  static constexpr size_t smem = sizeof(float) * (HIST_FLOATS + NW * (N + 2));
};

__device__ __forceinline__ float row_sum(float x) {  // over a row's 4 lanes
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Column sums over the warp's 8 rows; lanes 0..3 hold them.
template <int NC>
__device__ __forceinline__ void col_sums(float (&c)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    c[j] += __shfl_xor_sync(0xffffffffu, c[j], 4);
    c[j] += __shfl_xor_sync(0xffffffffu, c[j], 8);
    c[j] += __shfl_xor_sync(0xffffffffu, c[j], 16);
  }
}

template <typename T, int NC>
__device__ __forceinline__ void load_cols(const T* src, float (&o)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) o[j] = to_f32(src[j]);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(4 * P) ssd_bwd_kernel(const Params p) {
  using L = Layout<P, N>;
  constexpr int NTH = L::NTH, NC = L::NC, NW = L::NW, HT = L::HT;
  constexpr int NSEG = L::NSEG;
  extern __shared__ float smem[];
  float* hist = smem;               // HT states, element (j, tid) of step s
  float* red = hist + HIST_FLOATS;  // NW x N column partials
  float* red2 = red + NW * N;       // NW x 2 block partials

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row = tid / 4, c0 = (tid % 4) * NC;
  const int bh = blockIdx.x;  // b H + h
  const int b = bh / p.H, h = bh % p.H;
  const long long xs = (long long)p.H * P;  // x's time stride
  const long long xb = (long long)b * p.S * xs + (long long)h * P;
  const T* x = static_cast<const T*>(p.x) + xb;
  const T* dy = static_cast<const T*>(p.dy) + xb;
  T* dx = static_cast<T*>(p.dx) + xb;
  const float* dt = p.dt + (long long)b * p.S * p.H + h;
  float* ddt = p.ddt + (long long)b * p.S * p.H + h;
  const T* Bm = static_cast<const T*>(p.Bm) + (long long)b * p.S * N;
  const T* Cm = static_cast<const T*>(p.Cm) + (long long)b * p.S * N;
  // the head's partial rows: (b, t, h, :) at t H N from here
  const long long pb = ((long long)b * p.S * p.H + h) * N;
  float* dBp = p.dB_part + pb;
  float* dCp = p.dC_part + pb;
  const float Ah = p.A[h];
  const int nch = (p.S + CHUNK - 1) / CHUNK;
  // each thread reads back only the elements it wrote: no barrier needed
  float* ck = p.ckpt + (long long)bh * nch * P * N + row * N + c0;
  float* sg = p.seg + (long long)bh * NSEG * P * N + row * N + c0;

  // 1. forward: dC partials, and the state entering each chunk
  float st[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) st[j] = 0.f;
  for (int t = 0; t < p.S; ++t) {
    if (t % CHUNK == 0) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        ck[(long long)(t / CHUNK) * P * N + j] = st[j];
    }
    const float dtt = dt[(long long)t * p.H];
    const float a = expf(Ah * dtt);
    const float xd = dtt * to_f32(x[t * xs + row]);
    const float yd = to_f32(dy[t * xs + row]);
    float bb[NC], cp[NC];
    load_cols<T, NC>(Bm + (long long)t * N + c0, bb);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      st[j] = fmaf(a, st[j], xd * bb[j]);
      cp[j] = st[j] * yd;
    }
    col_sums<NC>(cp);
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < NC; ++j) red[warp * N + c0 + j] = cp[j];
    }
    __syncthreads();
    if (tid < N) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) s += red[ww * N + tid];
      dCp[(long long)t * p.H * N + tid] = s;
    }
    __syncthreads();  // red is read before the next step writes it
  }

  // 2. backward over the chunks, then their segments; g = Gh_t
  float g[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) g[j] = 0.f;
  float a_next = 1.f;  // a_{t+1}
  float dA_acc = 0.f;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int c0t = ch * CHUNK, c1t = min(p.S, c0t + CHUNK);
    const int nseg = (c1t - c0t + HT - 1) / HT;
    // the state entering each segment of the chunk
#pragma unroll
    for (int j = 0; j < NC; ++j) st[j] = ck[(long long)ch * P * N + j];
    for (int t = c0t;; ++t) {
      if ((t - c0t) % HT == 0) {
#pragma unroll
        for (int j = 0; j < NC; ++j)
          sg[(long long)((t - c0t) / HT) * P * N + j] = st[j];
      }
      if (t == c0t + (nseg - 1) * HT) break;
      const float dtt = dt[(long long)t * p.H];
      const float a = expf(Ah * dtt);
      const float xd = dtt * to_f32(x[t * xs + row]);
      float bb[NC];
      load_cols<T, NC>(Bm + (long long)t * N + c0, bb);
#pragma unroll
      for (int j = 0; j < NC; ++j) st[j] = fmaf(a, st[j], xd * bb[j]);
    }
    for (int seg = nseg - 1; seg >= 0; --seg) {
      const int t0 = c0t + seg * HT, t1 = min(c1t, t0 + HT);
#pragma unroll
      for (int j = 0; j < NC; ++j) st[j] = sg[(long long)seg * P * N + j];
      for (int t = t0; t < t1; ++t) {  // hist[t - t0] = h_{t-1}
        float* hs = hist + (t - t0) * NC * NTH + tid;
#pragma unroll
        for (int j = 0; j < NC; ++j) hs[j * NTH] = st[j];
        if (t + 1 == t1) break;
        const float dtt = dt[(long long)t * p.H];
        const float a = expf(Ah * dtt);
        const float xd = dtt * to_f32(x[t * xs + row]);
        float bb[NC];
        load_cols<T, NC>(Bm + (long long)t * N + c0, bb);
#pragma unroll
        for (int j = 0; j < NC; ++j) st[j] = fmaf(a, st[j], xd * bb[j]);
      }
      for (int t = t1 - 1; t >= t0; --t) {
        const float dtt = dt[(long long)t * p.H];
        const float a = expf(Ah * dtt);
        const float xv = to_f32(x[t * xs + row]);
        const float yd = to_f32(dy[t * xs + row]);
        float bb[NC], cc[NC], cp[NC];
        load_cols<T, NC>(Bm + (long long)t * N + c0, bb);
        load_cols<T, NC>(Cm + (long long)t * N + c0, cc);
        const float* hs = hist + (t - t0) * NC * NTH + tid;
        float q1 = 0.f, q2 = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          g[j] = fmaf(a_next, g[j], yd * cc[j]);  // now Gh_t
          q1 = fmaf(g[j], bb[j], q1);
          q2 = fmaf(g[j], hs[j * NTH], q2);
          cp[j] = dtt * xv * g[j];
        }
        q1 = row_sum(q1);
        q2 = row_sum(q2);
        if (tid % 4 == 0) dx[t * xs + row] = from_f32<T>(dtt * q1);
        float f1 = tid % 4 == 0 ? xv * q1 : 0.f;
        float f2 = tid % 4 == 0 ? q2 : 0.f;
        f1 = warp_sum(f1);
        f2 = warp_sum(f2);
        col_sums<NC>(cp);
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < NC; ++j) red[warp * N + c0 + j] = cp[j];
        }
        if (lane == 0) {
          red2[2 * warp] = f1;
          red2[2 * warp + 1] = f2;
        }
        __syncthreads();
        if (tid < N) {
          float s = 0.f;
#pragma unroll
          for (int ww = 0; ww < NW; ++ww) s += red[ww * N + tid];
          dBp[(long long)t * p.H * N + tid] = s;
        }
        if (tid == 0) {
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int ww = 0; ww < NW; ++ww) {
            s1 += red2[2 * ww];
            s2 += red2[2 * ww + 1];
          }
          ddt[(long long)t * p.H] = s1 + Ah * a * s2;
          dA_acc = fmaf(dtt * a, s2, dA_acc);
        }
        __syncthreads();  // red is read before the next step writes it
        a_next = a;
      }
    }
  }
  if (tid == 0) p.dA_part[bh] = dA_acc;
}

// out[o n + i] = sum_j part[(o m + j) n + i] over j < m, in order: dB and
// dC over the heads, dA over b.
template <typename T>
__global__ void sum_mid_kernel(const float* part, T* out, long long outer,
                               int m, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= outer * n) return;
  const long long o = i / n;
  const int c = (int)(i % n);
  const float* src = part + o * m * n + c;
  float s = 0.f;
  for (int j = 0; j < m; ++j) s += src[(long long)j * n];
  out[i] = from_f32<T>(s);
}

template <typename T>
cudaError_t sum_mid(const float* part, T* out, long long outer, int m, int n,
                    cudaStream_t stream) {
  const long long total = outer * n;
  sum_mid_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part, out, outer, m, n);
  return cudaGetLastError();
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, void* dB, void* dC, float* dA,
                   cudaStream_t stream) {
  using L = Layout<P, N>;
  auto kernel = ssd_bwd_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.B * p.H, L::NTH, L::smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rows = (long long)p.B * p.S;
  if ((err = sum_mid<T>(p.dB_part, static_cast<T*>(dB), rows, p.H, N,
                        stream)) != cudaSuccess)
    return err;
  if ((err = sum_mid<T>(p.dC_part, static_cast<T*>(dC), rows, p.H, N,
                        stream)) != cudaSuccess)
    return err;
  return sum_mid<float>(p.dA_part, dA, 1, p.B, p.H, stream);
}

template <typename T, int P>
cudaError_t dispatch_n(const Params& p, int N, void* dB, void* dC, float* dA,
                       cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, P, 16>(p, dB, dC, dA, st);
    case 32: return launch<T, P, 32>(p, dB, dC, dA, st);
    case 64: return launch<T, P, 64>(p, dB, dC, dA, st);
    case 128: return launch<T, P, 128>(p, dB, dC, dA, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int P, int N, void* dB, void* dC,
                     float* dA, cudaStream_t st) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(p, N, dB, dC, dA, st);
    case 32: return dispatch_n<T, 32>(p, N, dB, dC, dA, st);
    case 64: return dispatch_n<T, 64>(p, N, dB, dC, dA, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Scratch the wrapper allocates: ckpt B H ceil(S / 64) P N floats, seg
// B H (64 P N / 16384) P N, dB_part and dC_part B S H N, dA_part B H.
// Every tensor is contiguous: x, dy, dx (B, S, H, P); dt, ddt (B, S, H); A,
// dA (H,); B_, C, dB, dC (B, S, N).  dtype 0 is float32, 1 is bfloat16 (x,
// B_, C, dy, dx, dB, dC).  Returns the first failing launch's
// cudaGetLastError() (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* B_, const void* C, const void* dy,
                            void* dx, void* ddt, void* dA, void* dB, void* dC,
                            void* dA_part, void* dB_part, void* dC_part,
                            void* ckpt, void* seg, int Bb, int S, int H,
                            int P, int N, int dtype, void* stream) {
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           B_, C, dy, dx, static_cast<float*>(ddt),
           static_cast<float*>(dA_part), static_cast<float*>(dB_part),
           static_cast<float*>(dC_part), static_cast<float*>(ckpt),
           static_cast<float*>(seg), Bb, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dAf = static_cast<float*>(dA);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(p, P, N, dB, dC, dAf, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(p, P, N, dB, dC, dAf, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
