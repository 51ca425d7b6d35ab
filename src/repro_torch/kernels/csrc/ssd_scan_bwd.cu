// Mamba2 SSD scan backward for Hopper (sm_90a): dx, ddt, dA, dB, dC of the
// function csrc/ssd_scan.cu computes.  bf16 x, B, C, dy (ssd_scan_bwd_tc):
// chunk-parallel, the products on mma.sync; float32 (ssd_scan_bwd, the
// float32-compute parity path): PR 23's scalar walk over time, kept as it
// was.  dt and A float32; dx in x's dtype, dB and dC in B's, ddt and dA
// float32.
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
// No decay is inverted.  A padded row (x = 0, dt = 0: a = 1) carries the
// state through unchanged; the wrapper's caller cuts its gradients off
// (ops pads, F.pad's backward drops them).
//
// bf16 design (ssd_sum_kernel, scan_chunks_kernel, ssd_chunk_kernel;
// ref.ssd_scan_bwd_tc_ref mirrors it).  Time is cut into chunks of 64
// steps, acs the inclusive cumsum of A dt over a chunk (log2 units, one ex2
// an exponential); within a chunk, with h_in the state entering it and
// g_out the gradient leaving it:
//   h_t  = e^{acs_t} h_in + sum_{s<=t} e^{acs_t - acs_s} dt_s x_s B_s^T
//   Gh_t = sum_{tau>=t} e^{acs_tau - acs_t} dy_tau C_tau^T
//          + e^{acs_L - acs_t} g_out
// so every gradient is a product of the chunk's rows with a masked 64 x 64
// matrix or with h_in / g_out, and no step waits for the one before it.
//   (a) ssd_sum_kernel, a block a (chunk, h, b), only when S > 64: the
//       chunk's G = x^T (e^{acs_L - acs} dt B) (not for the last chunk)
//       and Q = dy^T (e^{acs} C) (not for the first), P x N each, written
//       one slot later / earlier than their chunk, and its decay e^{acs_L}.
//   (b) scan_chunks_kernel: h_in and g_out of every chunk, in place of G
//       and Q, a thread an element: ceil(S / 64) - 1 steps of h <- h dec +
//       G forward and g <- Q + dec g backward; at two chunks the shifted
//       slots already hold them and it is not launched.  B H nc P N fp32
//       each.
//   (c) ssd_chunk_kernel, a block a (chunk, group of hg heads, b), 4 warps,
//       warp w owning rows t of 16 w..16 w + 15, the heads of the group in
//       turn:
//         dx = dt (M^T dy + e^{acs_L - acs} B g_out^T),
//             M^T[t, tau] = (B_t.C_tau) e^{acs_tau - acs_t}, tau >= t;
//         dB = dt (M3^T C + e^{acs_L - acs} x g_out),
//             M3^T[t, tau] = (x_t.dy_tau) e^{acs_tau - acs_t};
//         dC = M2 B + e^{acs} dy h_in, M2[t, s] = (dy_t.x_s) e^{acs_t -
//             acs_s} dt_s, s <= t;
//         ddt = x.(Gh B) + A dla and dA = sum dt dla, with dla_t =
//             <Gh_t, a_t h_{t-1}> expanded: the corner sum over tau >= t >
//             s of Z = M2 o (C B^T), a reverse cumsum of e^{acs} dy.(h_in C),
//             a cumsum of e^{acs_L - acs} dt x.(B g_out^T), and e^{acs_L}
//             <g_out, h_in>.
//       The 16 x 16 blocks of the strips (C B^T, dy x^T, both exact bf16
//       products) are decayed in their accumulators and fed as split A
//       fragments to the next product, as in the forward (csrc/ssd_scan.cu);
//       off the diagonal block the decay factors through the acs of a block
//       edge, both exponents <= 0.  Z's prefix along s is a quad-lane scan
//       of the fragments, its column sums a shuffle over the rows and a
//       fixed-order sum over the warps.  Every fp32 operand (the decayed
//       strips, h_in, g_out) is split into hi = bf16(v) and lo = bf16(v -
//       hi), x, dy, B and C are exact: each product is 2 mma, ~16 mantissa
//       bits.  (a) and (b) are skipped where S <= 64: h_in = g_out = 0.
//   (d) The heads of a group add their dB and dC rows in shared memory
//       (each warp its own rows, in head order); the rows go out as bf16
//       when one group holds all H heads, else as fp32 partial rows
//       (B, S, H / hg, N) that ssd_finish_kernel adds over the groups in
//       order.  dA goes out per (b, chunk, h) and the same launch sums it
//       over b and the chunks, or it is written whole when B = 1 and S <=
//       64.  No atomics: the result does not depend on the order in
//       which blocks run, and two calls are bitwise equal.  The wrapper
//       picks hg (ssd_scan.heads_a_block): the most heads a block that
//       still leaves a block for every SM (two fit an SM at 64 x 64, so
//       the grid is one wave, and the fewest partial rows).
//
// What bounds it on an H100.  At zamba2-1.2b's training shape (B 8, S 128,
// H 64, P 64, N 64, bf16) the bytes (x, dy, dx in bf16, B, C, dB, dC in
// bf16, dt and ddt in fp32, each once: 26 MB) need 7.8 us at 3.35 TB/s;
// the products the design does are ~10 GFLOP (2 mma each: the strips, dx,
// dB, dC, the h_in / g_out sides), ~10 us at the tensor cores' 989
// TFLOP/s; the work the bound counts (kernels/flops.scan_flops) is less.
// A block's chain of heads (copies, acs, strips, row sums) is latency-
// bound; (c) runs B nc H / hg blocks (256 of 4 heads at that shape; 64 of
// one at the main path's 1 x 8, then the finish launch).
//
// The fp32 kernel (ssd_bwd_kernel, PR 23).  One block a (b, h), 4 P
// threads: thread i owns row i / 4 of h and of Gh and the N / 4 columns
// from (i % 4) N / 4 on, in registers.  Forward in time from h = 0 (dC
// partial rows, the state entering every 64-step chunk saved), then back
// over the chunks, recomputing each chunk's 64 KB segments of states into
// shared memory and walking them back with Gh (dx, ddt, dB partial rows);
// dB and dC per head into (B, S, H, N) fp32 scratch and dA per (b, h),
// summed by sum_mid_kernel.  Every sum in fp32: it holds the sequential
// oracle's float32 gradient at rounding level; ref.ssd_scan_bwd_ref is its
// plain version.  Bound by its sequential walk (three passes over time,
// block barriers every step).

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

// ---------------------------------------------------------------------------
// bf16: chunk-parallel, products on mma.sync
// ---------------------------------------------------------------------------

#include "scan_bwd_chunks.cuh"
#include "tc_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TL = 64;   // rows of a chunk
constexpr int TNT = 128;  // threads a block: 4 warps, warp w owns rows 16 w..
constexpr float LOG2E = 1.4426950408889634f;

struct TcParams {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  const bf16* dy;
  bf16* dx;
  float* ddt;
  float* dA;       // (H,), or dA_part (B, nc, H) when B nc > 1
  void* dB;        // (B, S, N) bf16 when one group, else (B, S, G, N) fp32
  void* dC;
  float* hst;      // (B, H, nc, P, N): G, then the state entering each chunk
  float* gst;      // (B, H, nc, P, N): Q, then the gradient leaving it
  float* dec;      // (B, H, nc): exp(acs) at the chunk's last row
  int B, S, H, hg;  // hg heads a block
};

// Shared memory of the two chunk kernels, in bytes; every piece a multiple
// of 16 bytes, rows read by ldmatrix padded by 8 bf16.
template <int P, int N>
struct TcL {
  static constexpr int XP = P + 8, NP = N + 8;
  // the chunk kernel
  static constexpr int BS = 0;               // B (TL x NP)
  static constexpr int CS = BS + TL * NP * 2;  // C
  static constexpr int XS = CS + TL * NP * 2;  // x (TL x XP)
  static constexpr int YS = XS + TL * XP * 2;  // dy
  static constexpr int HH = YS + TL * XP * 2;  // h_in hi (P x NP), lo
  static constexpr int HL = HH + P * NP * 2;
  static constexpr int GH = HL + P * NP * 2;   // g_out hi, lo
  static constexpr int GL = GH + P * NP * 2;
  static constexpr int DB = GL + P * NP * 2;   // dB, dC sums (TL x N fp32)
  static constexpr int DC = DB + TL * N * 4;
  static constexpr int DT = DC + TL * N * 4;   // dt (TL)
  static constexpr int ROW = DT + TL * 4;      // x.q1, v, u (3 x TL)
  static constexpr int CORNER = ROW + 3 * TL * 4;  // 4 warps x TL
  static constexpr int RED = CORNER + 4 * TL * 4;  // 4 partial sums
  static constexpr int BYTES = RED + 16;
  // the summary kernel: x, dy, then tail dt B and exp(acs) C split
  static constexpr int S_XS = 0;
  static constexpr int S_YS = S_XS + TL * XP * 2;
  static constexpr int S_BS = S_YS + TL * XP * 2;  // B, then C (raw)
  static constexpr int S_CS = S_BS + TL * NP * 2;
  static constexpr int S_TB = S_CS + TL * NP * 2;  // tail dt B hi, lo
  static constexpr int S_TBL = S_TB + TL * NP * 2;
  static constexpr int S_EC = S_TBL + TL * NP * 2;  // exp(acs) C hi, lo
  static constexpr int S_ECL = S_EC + TL * NP * 2;
  static constexpr int S_DT = S_ECL + TL * NP * 2;
  static constexpr int S_BYTES = S_DT + TL * 4;
};

__device__ __forceinline__ float wsum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Rows [t0, t0 + TL) of a (.., S, .., W) bf16 tensor (row stride rs
// elements, W a multiple of 8) into shared memory rows of ld elements;
// rows past S are zero-filled.
template <int W>
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src,
                                          long long rs, int n) {
  constexpr int CW = W / 8;
  for (int i = threadIdx.x; i < TL * CW; i += blockDim.x) {
    const int t = i / CW, c = i % CW;
    const bool in = t < n;
    tc::cp_async16(dst + t * ld + 8 * c, src + (in ? t : 0) * rs + 8 * c, in);
  }
}

// acs (the inclusive cumsum of A dt over the chunk, log2 units) as every
// warp holds it: lane l has rows 2 l and 2 l + 1 in c0, c1.
__device__ __forceinline__ void chunk_acs(const float* dts, float a2,
                                          float& c0, float& c1) {
  const int lane = threadIdx.x % 32;
  const float e0 = a2 * dts[2 * lane], e1 = a2 * dts[2 * lane + 1];
  float run = e0 + e1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  c1 = run;
  c0 = run - e1;
}

// acs at row r (any lane may ask for any row)
__device__ __forceinline__ float acs_at(float c0, float c1, int r) {
  const float u0 = __shfl_sync(0xffffffffu, c0, r / 2);
  const float u1 = __shfl_sync(0xffffffffu, c1, r / 2);
  return (r & 1) ? u1 : u0;
}

// (a) A chunk's summaries, one block a (chunk, h, b): G = x^T (tail dt B)
// into slot c + 1 of hst (not for the last chunk) and Q = dy^T (exp(acs)
// C) into slot c - 1 of gst (not for the first), P x N each, the scaled
// operand split; and the chunk's decay exp(acs_L).
template <int P, int N>
__global__ void __launch_bounds__(TNT) ssd_sum_kernel(const TcParams p) {
  using M = TcL<P, N>;
  constexpr int XP = M::XP, NP = M::NP;
  constexpr int MT = P / 16, WM = 4 / MT, SN = N / 8;
  constexpr int NJ = (SN + WM - 1) / WM;
  extern __shared__ __align__(16) unsigned char dsm[];
  bf16* xs = reinterpret_cast<bf16*>(dsm + M::S_XS);
  bf16* ys = reinterpret_cast<bf16*>(dsm + M::S_YS);
  bf16* bs = reinterpret_cast<bf16*>(dsm + M::S_BS);
  bf16* cs = reinterpret_cast<bf16*>(dsm + M::S_CS);
  bf16* tb = reinterpret_cast<bf16*>(dsm + M::S_TB);
  bf16* tbl = reinterpret_cast<bf16*>(dsm + M::S_TBL);
  bf16* ec = reinterpret_cast<bf16*>(dsm + M::S_EC);
  bf16* ecl = reinterpret_cast<bf16*>(dsm + M::S_ECL);
  float* dts = reinterpret_cast<float*>(dsm + M::S_DT);
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = (p.S + TL - 1) / TL, t0 = c * TL, n = min(TL, p.S - t0);
  const long long xrow = (long long)p.H * P;
  const long long xb = ((long long)b * p.S + t0) * xrow + (long long)h * P;
  copy_rows<P>(xs, XP, p.x + xb, xrow, n);
  copy_rows<P>(ys, XP, p.dy + xb, xrow, n);
  const long long nb = ((long long)b * p.S + t0) * N;
  copy_rows<N>(bs, NP, p.Bm + nb, N, n);
  copy_rows<N>(cs, NP, p.Cm + nb, N, n);
  if (tid < TL)
    tc::cp_async4(dts + tid,
                  p.dt + ((long long)b * p.S + t0 + (tid < n ? tid : 0)) * p.H + h,
                  tid < n);
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();
  float c0, c1;
  chunk_acs(dts, p.A[h] * LOG2E, c0, c1);
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  const bool want_g = c + 1 < nc, want_q = c > 0;
  // tail dt B and exp(acs) C, 8 columns of one row a step, split
  for (int i = tid; i < TL * N / 8; i += TNT) {  // TL N / 8: a multiple of TNT
    const int s = i / (N / 8), col = 8 * (i % (N / 8));
    const float as = acs_at(c0, c1, s);
    const float ft = exp2f(last - as) * dts[s], fe = exp2f(as);
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      const float2 bv = bf2(bs + s * NP + col + k);
      const float2 cv = bf2(cs + s * NP + col + k);
      uint32_t hi, lo;
      tc::split_pair(ft * bv.x, ft * bv.y, hi, lo);
      *reinterpret_cast<uint32_t*>(tb + s * NP + col + k) = hi;
      *reinterpret_cast<uint32_t*>(tbl + s * NP + col + k) = lo;
      tc::split_pair(fe * cv.x, fe * cv.y, hi, lo);
      *reinterpret_cast<uint32_t*>(ec + s * NP + col + k) = hi;
      *reinterpret_cast<uint32_t*>(ecl + s * NP + col + k) = lo;
    }
  }
  __syncthreads();
  const int mt = w % MT, j0 = (w / MT) * NJ;
  if (j0 >= SN) return;
  float ga[NJ][4], qa[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ga[j][e] = qa[j][e] = 0.f;
  const long long so = (((long long)b * p.H + h) * nc + c) * P * N;
  const int g = lane / 4, q4 = lane % 4;
  if (want_g) {
    tc::mma_tn<TL / 16, NJ>(ga, xs + 16 * mt, XP, tb + 8 * j0, NP);
    tc::mma_tn<TL / 16, NJ>(ga, xs + 16 * mt, XP, tbl + 8 * j0, NP);
    float* out = p.hst + so + P * N;  // slot c + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = (16 * mt + g) * N + 8 * (j0 + j) + 2 * q4;
      *reinterpret_cast<float2*>(out + o) = make_float2(ga[j][0], ga[j][1]);
      *reinterpret_cast<float2*>(out + o + 8 * N) =
          make_float2(ga[j][2], ga[j][3]);
    }
  }
  if (want_q) {
    tc::mma_tn<TL / 16, NJ>(qa, ys + 16 * mt, XP, ec + 8 * j0, NP);
    tc::mma_tn<TL / 16, NJ>(qa, ys + 16 * mt, XP, ecl + 8 * j0, NP);
    float* out = p.gst + so - P * N;  // slot c - 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = (16 * mt + g) * N + 8 * (j0 + j) + 2 * q4;
      *reinterpret_cast<float2*>(out + o) = make_float2(qa[j][0], qa[j][1]);
      *reinterpret_cast<float2*>(out + o + 8 * N) =
          make_float2(qa[j][2], qa[j][3]);
    }
  }
  if (tid == 0) p.dec[((long long)b * p.H + h) * nc + c] = exp2f(last);
}

// (c) Each chunk's gradients, one block a (chunk, group of hg heads, b);
// the heads of the group in turn, their dB and dC rows summed in shared
// memory.  See the header for the products.
// (registers sized for one block an SM: without the 1, ptxas held the
// small-N instances to 128 registers and spilled 4 bytes)
template <int P, int N>
__global__ void __launch_bounds__(TNT, 1) ssd_chunk_kernel(const TcParams p) {
  using M = TcL<P, N>;
  constexpr int XP = M::XP, NP = M::NP;
  extern __shared__ __align__(16) unsigned char dsm[];
  bf16* bs = reinterpret_cast<bf16*>(dsm + M::BS);
  bf16* cs = reinterpret_cast<bf16*>(dsm + M::CS);
  bf16* xs = reinterpret_cast<bf16*>(dsm + M::XS);
  bf16* ys = reinterpret_cast<bf16*>(dsm + M::YS);
  bf16* hhi = reinterpret_cast<bf16*>(dsm + M::HH);
  bf16* hlo = reinterpret_cast<bf16*>(dsm + M::HL);
  bf16* ghi = reinterpret_cast<bf16*>(dsm + M::GH);
  bf16* glo = reinterpret_cast<bf16*>(dsm + M::GL);
  float* dbs = reinterpret_cast<float*>(dsm + M::DB);
  float* dcs = reinterpret_cast<float*>(dsm + M::DC);
  float* dts = reinterpret_cast<float*>(dsm + M::DT);
  float* xq = reinterpret_cast<float*>(dsm + M::ROW);
  float* vv = xq + TL;
  float* uu = vv + TL;
  float* corner = reinterpret_cast<float*>(dsm + M::CORNER);
  float* red = reinterpret_cast<float*>(dsm + M::RED);

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int nc = (p.S + TL - 1) / TL, t0 = c * TL, n = min(TL, p.S - t0);
  const bool has_h = c > 0, has_g = c + 1 < nc;
  const int nblk = (n + 15) / 16;  // row blocks of 16 that hold rows < S
  const long long xrow = (long long)p.H * P;
  const long long nb = ((long long)b * p.S + t0) * N;
  copy_rows<N>(bs, NP, p.Bm + nb, N, n);
  copy_rows<N>(cs, NP, p.Cm + nb, N, n);
  for (int i = tid; i < TL * N; i += TNT) dbs[i] = dcs[i] = 0.f;
  const int r0 = 16 * w + g, r1 = r0 + 8;  // this thread's fragment rows

  for (int hh = 0; hh < p.hg; ++hh) {
    const int h = grp * p.hg + hh;
    if (hh) __syncthreads();  // the last head's reads are done
    const long long xb = ((long long)b * p.S + t0) * xrow + (long long)h * P;
    copy_rows<P>(xs, XP, p.x + xb, xrow, n);
    copy_rows<P>(ys, XP, p.dy + xb, xrow, n);
    if (tid < TL)
      tc::cp_async4(
          dts + tid,
          p.dt + ((long long)b * p.S + t0 + (tid < n ? tid : 0)) * p.H + h,
          tid < n);
    tc::cp_async_commit();
    // h_in and g_out, split; <g_out, h_in>
    float gh = 0.f;
    if (has_h || has_g) {
      const long long so = (((long long)b * p.H + h) * nc + c) * P * N;
      for (int i = tid; i < P * N / 2; i += TNT) {
        const int row = 2 * i / N, col = 2 * i % N;
        uint32_t hi, lo;
        float2 hv = make_float2(0.f, 0.f), gv = hv;
        if (has_h) {
          hv = *reinterpret_cast<const float2*>(p.hst + so + 2 * i);
          tc::split_pair(hv.x, hv.y, hi, lo);
          *reinterpret_cast<uint32_t*>(hhi + row * NP + col) = hi;
          *reinterpret_cast<uint32_t*>(hlo + row * NP + col) = lo;
        }
        if (has_g) {
          gv = *reinterpret_cast<const float2*>(p.gst + so + 2 * i);
          tc::split_pair(gv.x, gv.y, hi, lo);
          *reinterpret_cast<uint32_t*>(ghi + row * NP + col) = hi;
          *reinterpret_cast<uint32_t*>(glo + row * NP + col) = lo;
        }
        gh = fmaf(hv.x, gv.x, fmaf(hv.y, gv.y, gh));
      }
    }
    gh = wsum(gh);
    if (lane == 0) red[w] = gh;
    tc::cp_async_wait_all();
    __syncthreads();

    float c0, c1;
    const float Ah = p.A[h];
    chunk_acs(dts, Ah * LOG2E, c0, c1);
    const float last = __shfl_sync(0xffffffffu, c1, 31);
    const float at0 = acs_at(c0, c1, r0), at1 = acs_at(c0, c1, r1);
    const float dt0 = dts[r0], dt1 = dts[r1];
    const float tl0 = exp2f(last - at0), tl1 = exp2f(last - at1);

    // warps whose rows all lie past S (the main path's 8-token rows fill
    // one block of 16) only zero their row sums; blocks of tau past S are
    // skipped (their rows are zero)
    if (w < nblk) {
      // dx = dt (M^T dy + tail B g_out^T) and dB = dt (M3^T C + tail x g_out)
      // over tau >= t: M^T[t, tau] = B_t.C_tau e, M3^T[t, tau] = x_t.dy_tau e,
      // e = exp2(acs_tau - acs_t)
      float ax[P / 8][4], ab[N / 8][4];
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ax[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ab[j][e] = 0.f;
      float v0 = 0.f, v1 = 0.f;
      if (has_g) {
        tc::mma_nt2<N / 16, P / 16>(ax, bs + 16 * w * NP, NP, ghi, glo, NP);
        tc::mma_nn2<P / 16, N / 16>(ab, xs + 16 * w * XP, XP, ghi, glo, NP);
#pragma unroll
        for (int j = 0; j < P / 8; ++j) {
          ax[j][0] *= tl0, ax[j][1] *= tl0, ax[j][2] *= tl1, ax[j][3] *= tl1;
          const int col = 8 * j + 2 * q4;
          const float2 x0 = bf2(xs + r0 * XP + col), x1 = bf2(xs + r1 * XP + col);
          v0 = fmaf(x0.x, ax[j][0], fmaf(x0.y, ax[j][1], v0));
          v1 = fmaf(x1.x, ax[j][2], fmaf(x1.y, ax[j][3], v1));
        }
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          ab[j][0] *= tl0, ab[j][1] *= tl0, ab[j][2] *= tl1, ab[j][3] *= tl1;
      }
      v0 = quad_sum(v0) * dt0;
      v1 = quad_sum(v1) * dt1;
      {
        // below the warp's own block every tau lies past its last row r_w:
        // e = exp2(acs_tau - acs_rw) exp2(acs_rw - acs_t), both <= 0
        const float rw = acs_at(c0, c1, 16 * w + 15);
        const float f0 = exp2f(rw - at0), f1 = exp2f(rw - at1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < w) continue;
          if (kk >= nblk) break;
          float bc[2][4] = {}, xd[2][4] = {};
          tc::mma_nt<N / 16, 1>(bc, bs + 16 * w * NP, NP, cs + 16 * kk * NP, NP);
          tc::mma_nt<P / 16, 1>(xd, xs + 16 * w * XP, XP, ys + 16 * kk * XP, XP);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int s0 = 16 * kk + 8 * jj + 2 * q4;
            const int src = s0 / 2;
            const float a0 = __shfl_sync(0xffffffffu, c0, src);
            const float a1 = __shfl_sync(0xffffffffu, c1, src);
            float e00, e01, e10, e11;
            if (kk > w) {
              const float g0 = exp2f(a0 - rw), g1 = exp2f(a1 - rw);
              e00 = f0 * g0, e01 = f0 * g1, e10 = f1 * g0, e11 = f1 * g1;
            } else {
              e00 = s0 >= r0 ? exp2f(a0 - at0) : 0.f;
              e01 = s0 + 1 >= r0 ? exp2f(a1 - at0) : 0.f;
              e10 = s0 >= r1 ? exp2f(a0 - at1) : 0.f;
              e11 = s0 + 1 >= r1 ? exp2f(a1 - at1) : 0.f;
            }
            bc[jj][0] *= e00, bc[jj][1] *= e01, bc[jj][2] *= e10, bc[jj][3] *= e11;
            xd[jj][0] *= e00, xd[jj][1] *= e01, xd[jj][2] *= e10, xd[jj][3] *= e11;
          }
          uint32_t mh[4], ml[4];
          tc::frag_split(bc[0], bc[1], mh, ml);
          tc::mma_frag_nn<P / 16>(ax, mh, ml, ys + 16 * kk * XP, XP);
          tc::frag_split(xd[0], xd[1], mh, ml);
          tc::mma_frag_nn<N / 16>(ab, mh, ml, cs + 16 * kk * NP, NP);
        }
      }
      float q0 = 0.f, q1 = 0.f;  // x_t . (Gh_t B_t)
      {
        bf16* dxg = p.dx + xb;
#pragma unroll
        for (int j = 0; j < P / 8; ++j) {
          const int col = 8 * j + 2 * q4;
          const float2 x0 = bf2(xs + r0 * XP + col), x1 = bf2(xs + r1 * XP + col);
          q0 = fmaf(x0.x, ax[j][0], fmaf(x0.y, ax[j][1], q0));
          q1 = fmaf(x1.x, ax[j][2], fmaf(x1.y, ax[j][3], q1));
          if (r0 < n)
            *reinterpret_cast<uint32_t*>(dxg + r0 * xrow + col) =
                tc::pack_bf16(dt0 * ax[j][0], dt0 * ax[j][1]);
          if (r1 < n)
            *reinterpret_cast<uint32_t*>(dxg + r1 * xrow + col) =
                tc::pack_bf16(dt1 * ax[j][2], dt1 * ax[j][3]);
        }
      }
      q0 = quad_sum(q0);
      q1 = quad_sum(q1);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {  // this head's dB rows, summed
        const int col = 8 * j + 2 * q4;
        float2* d0 = reinterpret_cast<float2*>(dbs + r0 * N + col);
        float2* d1 = reinterpret_cast<float2*>(dbs + r1 * N + col);
        d0->x += dt0 * ab[j][0], d0->y += dt0 * ab[j][1];
        d1->x += dt1 * ab[j][2], d1->y += dt1 * ab[j][3];
      }

      // dC = M2 B + exp(acs) dy h_in over s <= t, M2[t, s] = dy_t.x_s e dt_s
      // (e = exp2(acs_t - acs_s)); the corner sums of Z = M2 o C B^T
      float ac[N / 8][4];
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ac[j][e] = 0.f;
      if (has_h) {
        tc::mma_nn2<P / 16, N / 16>(ac, ys + 16 * w * XP, XP, hhi, hlo, NP);
        const float f0 = exp2f(at0), f1 = exp2f(at1);
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          ac[j][0] *= f0, ac[j][1] *= f0, ac[j][2] *= f1, ac[j][3] *= f1;
      }
      {
        float run0 = 0.f, run1 = 0.f;  // sums of Z left of the tile, rows r0, r1
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk > w) break;
          float dxs[2][4] = {}, cb[2][4] = {};
          tc::mma_nt<P / 16, 1>(dxs, ys + 16 * w * XP, XP, xs + 16 * kk * XP, XP);
          tc::mma_nt<N / 16, 1>(cb, cs + 16 * w * NP, NP, bs + 16 * kk * NP, NP);
          // below the diagonal block: through e_k, the acs of block kk's last
          // row, both exponents <= 0
          const float ek = acs_at(c0, c1, 16 * kk + 15);
          const float f0 = exp2f(at0 - ek), f1 = exp2f(at1 - ek);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int s0 = 16 * kk + 8 * jj + 2 * q4;
            const int src = s0 / 2;
            const float a0 = __shfl_sync(0xffffffffu, c0, src);
            const float a1 = __shfl_sync(0xffffffffu, c1, src);
            const float d0 = dts[s0], d1 = dts[s0 + 1];
            float e00, e01, e10, e11;
            if (kk < w) {
              const float g0 = exp2f(ek - a0) * d0, g1 = exp2f(ek - a1) * d1;
              e00 = f0 * g0, e01 = f0 * g1, e10 = f1 * g0, e11 = f1 * g1;
            } else {
              e00 = s0 <= r0 ? exp2f(at0 - a0) * d0 : 0.f;
              e01 = s0 + 1 <= r0 ? exp2f(at0 - a1) * d1 : 0.f;
              e10 = s0 <= r1 ? exp2f(at1 - a0) * d0 : 0.f;
              e11 = s0 + 1 <= r1 ? exp2f(at1 - a1) * d1 : 0.f;
            }
            float* m = dxs[jj];
            m[0] *= e00, m[1] *= e01, m[2] *= e10, m[3] *= e11;
            // Z's exclusive prefix along s within each row (quad lanes hold
            // the tile's columns 2 q4, 2 q4 + 1), then its column sums over
            // the rows tau >= the column
            float colsum0 = 0.f, colsum1 = 0.f;
            auto prefix = [&](float za, float zb, int row, float& run) {
              float incl = za + zb;
              float o = __shfl_up_sync(0xffffffffu, incl, 1, 4);
              if (q4 >= 1) incl += o;
              o = __shfl_up_sync(0xffffffffu, incl, 2, 4);
              if (q4 >= 2) incl += o;
              float ex = __shfl_up_sync(0xffffffffu, incl, 1, 4);
              if (q4 == 0) ex = 0.f;
              const float pa = run + ex, pb = pa + za;
              colsum0 += row >= s0 ? pa : 0.f;
              colsum1 += row >= s0 + 1 ? pb : 0.f;
              run += __shfl_sync(0xffffffffu, incl, 3, 4);
            };
            prefix(m[0] * cb[jj][0], m[1] * cb[jj][1], r0, run0);
            prefix(m[2] * cb[jj][2], m[3] * cb[jj][3], r1, run1);
#pragma unroll
            for (int off = 4; off < 32; off *= 2) {
              colsum0 += __shfl_xor_sync(0xffffffffu, colsum0, off);
              colsum1 += __shfl_xor_sync(0xffffffffu, colsum1, off);
            }
            if (lane < 4) {
              corner[w * TL + s0] = colsum0;
              corner[w * TL + s0 + 1] = colsum1;
            }
          }
          uint32_t mh[4], ml[4];
          tc::frag_split(dxs[0], dxs[1], mh, ml);
          tc::mma_frag_nn<N / 16>(ac, mh, ml, bs + 16 * kk * NP, NP);
        }
      }
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {  // this head's dC rows, summed
        const int col = 8 * j + 2 * q4;
        float2* d0 = reinterpret_cast<float2*>(dcs + r0 * N + col);
        float2* d1 = reinterpret_cast<float2*>(dcs + r1 * N + col);
        d0->x += ac[j][0], d0->y += ac[j][1];
        d1->x += ac[j][2], d1->y += ac[j][3];
      }
      // u_t = exp(acs_t) dy_t . (h_in C_t)
      float u0 = 0.f, u1 = 0.f;
      if (has_h) {
        float ch[P / 8][4];
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ch[j][e] = 0.f;
        tc::mma_nt2<N / 16, P / 16>(ch, cs + 16 * w * NP, NP, hhi, hlo, NP);
#pragma unroll
        for (int j = 0; j < P / 8; ++j) {
          const int col = 8 * j + 2 * q4;
          const float2 y0 = bf2(ys + r0 * XP + col), y1 = bf2(ys + r1 * XP + col);
          u0 = fmaf(y0.x, ch[j][0], fmaf(y0.y, ch[j][1], u0));
          u1 = fmaf(y1.x, ch[j][2], fmaf(y1.y, ch[j][3], u1));
        }
        u0 = quad_sum(u0) * exp2f(at0);
        u1 = quad_sum(u1) * exp2f(at1);
      }
      if (q4 == 0) {
        xq[r0] = q0, xq[r1] = q1;
        vv[r0] = v0, vv[r1] = v1;
        uu[r0] = u0, uu[r1] = u1;
      }
    } else if (q4 == 0) {
      xq[r0] = xq[r1] = vv[r0] = vv[r1] = uu[r0] = uu[r1] = 0.f;
    }
    __syncthreads();
    // dla_t = corner_t + sum_{tau >= t} u + sum_{s < t} v + exp(acs_L)
    // <g_out, h_in>; ddt = x.q1 + A dla; dA = sum dt dla.  Warp 0: lane l
    // has rows 2 l, 2 l + 1.
    if (w == 0) {
      const int ra = 2 * lane, rb = ra + 1;
      const float kg = exp2f(last) * (red[0] + red[1] + red[2] + red[3]);
      float cna = 0.f, cnb = 0.f;
      for (int ww = ra / 16; ww < nblk; ++ww) {
        cna += corner[ww * TL + ra];
        cnb += corner[ww * TL + rb];
      }
      const float ua = uu[ra], ub = uu[rb], va = vv[ra], vb = vv[rb];
      float sv = va + vb, su = ua + ub;  // inclusive scans: v up, u down
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, sv, off);
        if (lane >= off) sv += o;
        const float od = __shfl_down_sync(0xffffffffu, su, off);
        if (lane + off < 32) su += od;
      }
      float vex = __shfl_up_sync(0xffffffffu, sv, 1);
      if (lane == 0) vex = 0.f;
      float uex = __shfl_down_sync(0xffffffffu, su, 1);
      if (lane == 31) uex = 0.f;
      const float la = cna + (uex + ub + ua) + vex + kg;
      const float lb = cnb + (uex + ub) + (vex + va) + kg;
      float* ddt = p.ddt + ((long long)b * p.S + t0) * p.H + h;
      if (ra < n) ddt[(long long)ra * p.H] = xq[ra] + Ah * la;
      if (rb < n) ddt[(long long)rb * p.H] = xq[rb] + Ah * lb;
      const float da = wsum(fmaf(dts[ra], la, dts[rb] * lb));
      if (lane == 0) {
        if (p.B * nc == 1)
          p.dA[h] = da;
        else
          p.dA[((long long)b * nc + c) * p.H + h] = da;
      }
    }
  }
  __syncthreads();
  // the group's dB and dC rows: bf16 when one group holds every head,
  // else fp32 partial rows (B, S, G, N) for the sum over groups
  const int G = p.H / p.hg;
  for (int i = tid; i < n * N; i += TNT) {
    const int t = i / N, col = i % N;
    const long long row = (long long)b * p.S + t0 + t;
    if (G == 1) {
      static_cast<bf16*>(p.dB)[row * N + col] = __float2bfloat16(dbs[i]);
      static_cast<bf16*>(p.dC)[row * N + col] = __float2bfloat16(dcs[i]);
    } else {
      static_cast<float*>(p.dB)[(row * G + grp) * N + col] = dbs[i];
      static_cast<float*>(p.dC)[(row * G + grp) * N + col] = dcs[i];
    }
  }
}

// (d) The sums over blocks in one launch, each in a fixed order: dB and dC
// over the head groups (nbc = B S N elements when there is more than one
// group, else 0) and dA over b and the chunks (nh = H when there is more
// than one (b, chunk), else 0).  A group of lanes an output element (lgb
// lanes for dB and dC, lga for dA: powers of 2 up to 32, dA's warps after
// dB's): lane l takes the parts l, l + lg, ... and a butterfly adds the
// lanes (every lane ends with the same bits: a + b == b + a in fp32).
__global__ void ssd_finish_kernel(const float* dBp, const float* dCp,
                                  bf16* dB, bf16* dC, int nbc, int G,
                                  int N, const float* dAp, float* dA, int m,
                                  int nh, int lgb, int lga) {
  // 32-bit index arithmetic (B S N lg < 2^31 at every size the wrapper
  // takes): 64-bit division is a long software sequence
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int bc_threads = (nbc * lgb + 31) / 32 * 32;
  const bool is_bc = t < bc_threads;
  const int lg = is_bc ? lgb : lga;
  const int u = is_bc ? t : t - bc_threads;
  const int i = u / lg, lane = u % lg;
  float sb = 0.f, sc = 0.f, sa = 0.f;
  if (is_bc && i < nbc) {
    const long long o = (long long)(i / N) * G * N + i % N;
    for (int j = lane; j < G; j += lg) {
      sb += dBp[o + (long long)j * N];
      sc += dCp[o + (long long)j * N];
    }
  } else if (!is_bc && i < nh) {
    for (int j = lane; j < m; j += lg) sa += dAp[(long long)j * nh + i];
  }
  for (int off = lg / 2; off > 0; off /= 2) {  // warp-uniform lg
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
    sc += __shfl_xor_sync(0xffffffffu, sc, off);
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
  }
  if (lane) return;
  if (is_bc && i < nbc) {
    dB[i] = __float2bfloat16(sb);
    dC[i] = __float2bfloat16(sc);
  } else if (!is_bc && i < nh) {
    dA[i] = sa;
  }
}

template <typename K>
cudaError_t tc_launch_with(K kernel, size_t smem, dim3 grid, const TcParams& p,
                           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, TNT, smem, st>>>(p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t tc_launch(const TcParams& p, void* dB, void* dC, float* dA,
                      cudaStream_t st) {
  using M = TcL<P, N>;
  const int nc = (p.S + TL - 1) / TL, G = p.H / p.hg;
  cudaError_t err;
  if (nc > 1) {
    if ((err = tc_launch_with(ssd_sum_kernel<P, N>, M::S_BYTES,
                              dim3(nc, p.H, p.B), p, st)) != cudaSuccess)
      return err;
    if (nc > 2) {
      scan_chunks_kernel<<<dim3((P * N + 255) / 256, p.B * p.H), 256, 0,
                            st>>>(p.hst, p.gst, p.dec, nc, P * N, 1);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  if ((err = tc_launch_with(ssd_chunk_kernel<P, N>, M::BYTES,
                            dim3(nc, G, p.B), p, st)) != cudaSuccess)
    return err;
  const int nbc = G > 1 ? p.B * p.S * N : 0;
  const int nh = p.B * nc > 1 ? p.H : 0;
  if (nbc + nh == 0) return cudaSuccess;
  auto lanes = [](int parts) {
    int lg = 1;
    while (lg < parts && lg < 32) lg *= 2;
    return lg;
  };
  const int lgb = lanes(G), lga = lanes(p.B * nc);
  const int threads = (nbc * lgb + 31) / 32 * 32 + nh * lga;
  ssd_finish_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(p.dB), static_cast<const float*>(p.dC),
      static_cast<bf16*>(dB), static_cast<bf16*>(dC), nbc, G, N, p.dA, dA,
      p.B * nc, nh, lgb, lga);
  return cudaGetLastError();
}

template <int P>
cudaError_t tc_dispatch_n(const TcParams& p, int N, void* dB, void* dC,
                          float* dA, cudaStream_t st) {
  switch (N) {
    case 16: return tc_launch<P, 16>(p, dB, dC, dA, st);
    case 32: return tc_launch<P, 32>(p, dB, dC, dA, st);
    case 64: return tc_launch<P, 64>(p, dB, dC, dA, st);
    case 128: return tc_launch<P, 128>(p, dB, dC, dA, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// The fp32 kernel.  Scratch the wrapper allocates: ckpt B H ceil(S / 64) P
// N floats, seg B H (64 P N / 16384) P N, dB_part and dC_part B S H N,
// dA_part B H.  Every tensor is contiguous: x, dy, dx (B, S, H, P); dt, ddt
// (B, S, H); A, dA (H,); B_, C, dB, dC (B, S, N).  dtype 0 is float32.
// Returns the first failing launch's cudaGetLastError() (0 on success).
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
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The bf16 kernels.  Scratch the wrapper allocates (ssd_scan.bwd_scratch):
// dA_part B ceil(S / 64) H floats, dB_part and dC_part B S (H / hg) N, hst
// and gst B H ceil(S / 64) P N, dec B H ceil(S / 64) (the last three used
// only when S > 64, the partial rows only when hg < H).  Shapes and
// contiguity as above, x, B_, C, dy, dx, dB, dC bfloat16 and 16-byte
// aligned; hg divides H, and B S N < 2^26 where hg < H.  Returns the
// first failing launch's cudaGetLastError() (0 on success).
extern "C" int ssd_scan_bwd_tc(const void* x, const void* dt, const void* A,
                               const void* B_, const void* C, const void* dy,
                               void* dx, void* ddt, void* dA, void* dB,
                               void* dC, void* dA_part, void* dB_part,
                               void* dC_part, void* hst, void* gst, void* dec,
                               int Bb, int S, int H, int P, int N, int hg,
                               void* stream) {
  if (hg < 1 || H % hg) return static_cast<int>(cudaErrorInvalidValue);
  // the sums over head groups index B S N x 32 lanes in 32 bits
  if (hg < H && (long long)Bb * S * N * 32 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned16(x) && aligned16(B_) && aligned16(C) && aligned16(dy)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int nc = (S + TL - 1) / TL;
  const bool one_group = hg == H;
  TcParams p{static_cast<const bf16*>(x), static_cast<const float*>(dt),
             static_cast<const float*>(A), static_cast<const bf16*>(B_),
             static_cast<const bf16*>(C), static_cast<const bf16*>(dy),
             static_cast<bf16*>(dx), static_cast<float*>(ddt),
             static_cast<float*>(Bb * nc == 1 ? dA : dA_part),
             one_group ? dB : dB_part, one_group ? dC : dC_part,
             static_cast<float*>(hst), static_cast<float*>(gst),
             static_cast<float*>(dec), Bb, S, H, hg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dAf = static_cast<float*>(dA);
  cudaError_t err;
  switch (P) {
    case 16: err = tc_dispatch_n<16>(p, N, dB, dC, dAf, st); break;
    case 32: err = tc_dispatch_n<32>(p, N, dB, dC, dAf, st); break;
    case 64: err = tc_dispatch_n<64>(p, N, dB, dC, dAf, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
