// RWKV6 (Finch) WKV scan backward for Hopper (sm_90a): dr, dk, dv, dw, du
// of the function csrc/wkv6_scan.cu computes.  bf16 r, k, v, dy
// (wkv6_scan_bwd_tc): chunk-parallel in 16-step sub-tiles, the products on
// mma.sync; float32 (wkv6_scan_bwd, the float32-compute parity path): PR
// 23's scalar walk over time, kept as it was.  w and u float32; dr, dk, dv
// in r's dtype, dw and du float32.
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
// division by wc near the clip, log 1e-12 = -27.6 a step, overflows, and
// the gated-linear-attention identity d log w = revcumsum(r dr - k dk)
// reads rounding as gradient there), and no difference of long sums
// cancels.
//
// bf16 design (wkv_sum_kernel, scan_chunks_kernel, wkv_sub_kernel;
// ref.wkv6_scan_bwd_tc_ref mirrors it).  Cumsums of lw = log2 clip(w) are
// taken from an anchor in the order that makes every exponent <= 0; no
// factor goes through a reference point that would need a clamp.
//   (a) wkv_sum_kernel, a block a (64-step chunk, h, b), only when S > 64:
//       the chunk's G = (k exp(cl_L - cl))^T v (not for the last chunk)
//       and Q = (r exp(ecl))^T dy (not for the first), D x D each, written
//       one slot later / earlier than their chunk, and its decay exp(cl_L)
//       a row.
//   (b) scan_chunks_kernel: the state entering every chunk (h_in) and the
//       gradient leaving it (g_out), in place of G and Q, a thread an
//       element: ceil(S / 64) - 1 steps each way (not launched at two
//       chunks, where the shifted slots hold them).  B H nc D^2 fp32
//       each.
//   (c) wkv_sub_kernel, a block a (16-step sub-tile, h, b), 8 warps: no
//       step waits for another.  The state entering the sub-tile S^j is
//       h_in decayed to its start plus the chunk's earlier rows, (k
//       exp(decay to the start))^T v; the gradient leaving it G^j is g_out
//       decayed back to its end plus the chunk's later rows, (r exp(decay
//       from the end))^T dy: each a product over at most 48 rows, warp w
//       owning state rows 16 w.., in fp32 accumulators, then split into
//       shared memory.  Then, per sub-tile (ecl / cl the exclusive /
//       inclusive cumsums over its 16 rows, cL the last):
//         dr_t = exp(ecl_t) (S^j dy_t) + sum_{s<t} e_ts k_s (v_s.dy_t)
//                + u k_t (v_t.dy_t)
//         dk_t = sum_{tau>t} e_taut r_tau (v_t.dy_tau)
//                + exp(cL - cl_t) (G^j v_t) + r_t u (v_t.dy_t)
//         dv   = att^T dy + (k exp(cL - cl)) G^j, att[tau, t] = sum_d r_tau
//                e_taut k_t (tau > t), the bonus r.u.k on its diagonal
//         dw_t = exp(cL - cl_t) exp(ecl_t) <G^j, S^j>_d
//                + exp(cL - cl_t) sum_{s<t} e_ts k_s (G^j v_s)
//                + exp(ecl_t) sum_{tau>t} e_taut r_tau (S^j dy_tau)
//                + sum_{tau>t>s} e_taut e_ts r_tau k_s (v_s.dy_tau)
//       with e_ts = exp(ecl_t - cl_s) <= 1 (s < t): every exponential
//       <= 1.  S^j dy^T, G^j v^T, dy v^T, att^T dy and the k side of dv run
//       on mma.sync (a 16-column strip a job); the (t, s, d) pairwise terms
//       run a thread a (channel, part of the rows) in fp32, att as the
//       forward's packed pairs (csrc/wkv6_scan.cu).  Operands carrying
//       history (S^j, G^j, the scaled rows, att) are split into hi =
//       bf16(v) and lo = bf16(v - hi); r, k, v, dy are exact.  (a) and (b)
//       are skipped where S <= 64: h_in = g_out = 0; where S <= 16 the
//       states are zero and only the sub-tile's own terms run.
//   (d) du goes out per (b, sub-tile) and sum_rows_kernel adds it over
//       both in a fixed order, or it is written whole when B = 1 and S <=
//       16 (then the backward is one launch).  No atomics: two calls are
//       bitwise equal.
//
// What bounds it on an H100.  At rwkv6-3b's training shape (B 8, S 128,
// H 40, D 64, bf16) the bytes (r, k, v, dy, dr, dk, dv in bf16, w and dw in
// fp32, each once: 58 MB) need 17 us at 3.35 TB/s, far above the products'
// time at the tensor cores' rate; the pairwise phase (~240 exponentials a
// channel and sub-tile, the forward's att among them, and the triple terms'
// ~560 FMAs) and the sub-tile's chain of barriers bound a block, hidden by
// the B H S / 16 blocks in flight (2,560 at that shape, 40 at the main
// path's 1 x 8).
//
// The fp32 kernel (wkv6_bwd_kernel, PR 23).  One block a (b, h), 4 D
// threads: thread i owns row i / 4 of S and of G and the D / 4 columns from
// (i % 4) D / 4 on, in registers.  Forward in time from S = 0 (dr, the
// state entering every 64-step chunk saved), then back over the chunks,
// recomputing each chunk's 64 KB segments of states into shared memory and
// walking them back with G (dk, dv, dw); du partial rows a (b, h) summed
// over b by sum_rows_kernel.  Every sum in fp32: it holds the sequential
// oracle's float32 gradient at rounding level; ref.wkv6_scan_bwd_ref is
// its plain version.  Bound by its sequential walk (three passes over
// time, two block barriers a step of the last).

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

// ---------------------------------------------------------------------------
// bf16: chunk-parallel, 16-step sub-tiles, products on mma.sync
// ---------------------------------------------------------------------------

#include "scan_bwd_chunks.cuh"
#include "tc_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TL = 64;    // steps of a chunk
constexpr int LS = 16;    // steps of a sub-tile
constexpr int TNT = 128;  // threads a block of the summary kernel: 4 warps
constexpr int SNT = 256;  // and of the sub-tile kernel: 8 warps

struct TcParams {
  const bf16* r;
  const bf16* k;
  const bf16* v;
  const float* w;
  const float* u;
  const bf16* dy;
  bf16* dr;
  bf16* dk;
  bf16* dv;
  float* dw;
  float* du;   // (H, D), or du_part (B, nsub, H, D) when B nsub > 1
  float* hst;  // (B, H, nc, D, D): G, then the state entering each chunk
  float* gst;  // (B, H, nc, D, D): Q, then the gradient leaving it
  float* dec;  // (B, H, nc, D): the chunk's decay a state row
  int B, S, H;
};

// log2 of clip(w, 1e-12, 1): the cumsums are kept in log2 units, as the
// forward's (one MUFU lg2, relative error ~2^-22: ~1e-5 of an exponent at
// the clip's -39.9 a step)
__device__ __forceinline__ float log2w(float w) {
  return __log2f(fminf(fmaxf(w, W_MIN), 1.f));
}

__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int i,
                                            float x) {
  const bf16 h = __float2bfloat16(x);
  hi[i] = h;
  lo[i] = __float2bfloat16(x - __bfloat162float(h));
}

// N consecutive values from shared memory, as wide loads as N allows
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
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
__device__ __forceinline__ void lds(const bf16* p, float (&o)[N]) {
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

// rows [t0, t0 + n) of a (B, S, H, D) tensor at src (= its (b, t0, h)
// element; row stride rs) into `rows` shared-memory rows of ld elements,
// zero-filled past n
template <typename T, int D>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          long long rs, int n, int rows) {
  constexpr int CW = D * sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int EW = 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * CW; i += blockDim.x) {
    const int t = i / CW, c = i % CW;
    const bool in = t < n;
    tc::cp_async16(dst + t * ld + EW * c, src + (in ? t : 0) * rs + EW * c,
                   in);
  }
}

// The sub-tile kernel's shared memory, in bytes; pieces multiples of 16.
template <int D>
struct SubL {
  static constexpr int DP = D + 8, AL = LS + 8;
  static constexpr int R = 0;  // the sub-tile's r, k, v, dy (LS x DP)
  static constexpr int K = R + LS * DP * 2;
  static constexpr int V = K + LS * DP * 2;
  static constexpr int Y = V + LS * DP * 2;
  static constexpr int W = Y + LS * DP * 2;      // its w (LS x D fp32)
  static constexpr int RA = W + LS * D * 4;      // up to 48 rows of the
  static constexpr int RB = RA + 48 * DP * 2;    // chunk: k, v before the
  static constexpr int RW = RB + 48 * DP * 2;    // sub-tile or r, dy after,
  static constexpr int RS = RW + 48 * D * 4;     // w (then its exponents),
  static constexpr int RSL = RS + 48 * DP * 2;   // the scaled rows (hi, lo)
  static constexpr int SH = RSL + 48 * DP * 2;   // S^j hi, lo (D x DP)
  static constexpr int SL = SH + D * DP * 2;
  static constexpr int GH = SL + D * DP * 2;     // G^j hi, lo
  static constexpr int GL = GH + D * DP * 2;
  static constexpr int SY = GL + D * DP * 2;     // dy S^j^T (LS x D fp32)
  static constexpr int GV = SY + LS * D * 4;     // v G^j^T
  static constexpr int VY = GV + LS * D * 4;     // dy_t . v_s (LS x LS)
  static constexpr int ECL = VY + LS * LS * 4;   // cumsums (LS x D)
  static constexpr int CL = ECL + LS * D * 4;
  static constexpr int AT = CL + LS * D * 4;     // att^T hi, lo (LS x AL)
  static constexpr int ATL = AT + LS * AL * 2;
  static constexpr int KL = ATL + LS * AL * 2;   // k exp(cL - cl) hi, lo
  static constexpr int KLL = KL + LS * DP * 2;
  static constexpr int VEC = KLL + LS * DP * 2;  // X, Xg, <G, S>, u (4 D)
  static constexpr int DU = VEC + 4 * D * 4;     // du partials (SNT)
  static constexpr int BYTES = DU + SNT * 4;
};

// The summary kernel's: the chunk's k, v, r, dy (TL x DP), w (TL x D),
// k exp(cl_L - cl) and r exp(ecl) split.
template <int D>
struct SumL {
  static constexpr int DP = D + 8;
  static constexpr int K = 0;
  static constexpr int V = K + TL * DP * 2;
  static constexpr int R = V + TL * DP * 2;
  static constexpr int Y = R + TL * DP * 2;
  static constexpr int W = Y + TL * DP * 2;
  static constexpr int KT = W + TL * D * 4;
  static constexpr int KTL = KT + TL * DP * 2;
  static constexpr int RE = KTL + TL * DP * 2;
  static constexpr int REL = RE + TL * DP * 2;
  static constexpr int TOT = REL + TL * DP * 2;  // a part's lw sum (TNT)
  static constexpr int BYTES = TOT + TNT * 4;
};

// (a) A chunk's summaries, a block a (chunk, h, b): G = (k exp(cl_L -
// cl))^T v into slot c + 1 of hst (not for the last chunk) and Q = (r
// exp(ecl))^T dy into slot c - 1 of gst (not for the first), D x D each,
// the scaled operand split; and its decay exp(cl_L) a row.
template <int D>
__global__ void __launch_bounds__(TNT) wkv_sum_kernel(const TcParams p) {
  using M = SumL<D>;
  constexpr int DP = M::DP;
  extern __shared__ __align__(16) unsigned char dsm[];
  bf16* ks = reinterpret_cast<bf16*>(dsm + M::K);
  bf16* vs = reinterpret_cast<bf16*>(dsm + M::V);
  bf16* rs = reinterpret_cast<bf16*>(dsm + M::R);
  bf16* ys = reinterpret_cast<bf16*>(dsm + M::Y);
  float* ws = reinterpret_cast<float*>(dsm + M::W);
  bf16* kt = reinterpret_cast<bf16*>(dsm + M::KT);
  bf16* ktl = reinterpret_cast<bf16*>(dsm + M::KTL);
  bf16* re = reinterpret_cast<bf16*>(dsm + M::RE);
  bf16* rel = reinterpret_cast<bf16*>(dsm + M::REL);
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = (p.S + TL - 1) / TL, t0 = c * TL, n = min(TL, p.S - t0);
  const long long row = (long long)p.H * D;
  const long long base = ((long long)b * p.S + t0) * row + (long long)h * D;
  copy_rows<bf16, D>(ks, DP, p.k + base, row, n, TL);
  copy_rows<bf16, D>(vs, DP, p.v + base, row, n, TL);
  copy_rows<bf16, D>(rs, DP, p.r + base, row, n, TL);
  copy_rows<bf16, D>(ys, DP, p.dy + base, row, n, TL);
  copy_rows<float, D>(ws, D, p.w + base, row, n, TL);
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();
  const long long so = ((long long)b * p.H + h) * nc + c;
  {
    // TPC threads a channel, each a run of RP rows: its lw and their sum,
    // then the sums of the runs before (forward) and after (backward) it
    // from the others', in a fixed order
    constexpr int TPC = TNT / D, RP = TL / TPC;
    float* tot = reinterpret_cast<float*>(dsm + M::TOT);
    const int d = tid % D, part = tid / D;
    float lw[RP], sum = 0.f;
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int t = part * RP + i;
      lw[i] = t < n ? log2w(ws[t * D + d]) : 0.f;
      sum += lw[i];
    }
    tot[tid] = sum;
    __syncthreads();
    float fwd = 0.f, rev = 0.f, all = 0.f;
#pragma unroll
    for (int pp = 0; pp < TPC; ++pp) {
      const float x = tot[pp * D + d];
      if (pp < part) fwd += x;
      if (pp > part) rev += x;
      all += x;
    }
    if (c > 0) {  // r exp(ecl), forward
      float run = fwd;
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int t = part * RP + i;
        store_split(re, rel, t * DP + d,
                    __bfloat162float(rs[t * DP + d]) * exp2f(run));
        run += lw[i];
      }
    }
    if (c + 1 < nc) {  // k exp(cl_L - cl), backward
      float run = rev;
#pragma unroll
      for (int i = RP - 1; i >= 0; --i) {
        const int t = part * RP + i;
        store_split(kt, ktl, t * DP + d,
                    __bfloat162float(ks[t * DP + d]) * exp2f(run));
        run += lw[i];
      }
    }
    if (part == 0) p.dec[so * D + d] = exp2f(all);
  }
  __syncthreads();
  if (w >= D / 16) return;
  const int g = lane / 4, q4 = lane % 4;
  auto product = [&](const bf16* ah, const bf16* al, const bf16* rows,
                     float* out) {
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    tc::mma_tn<TL / 16, D / 8>(acc, al + 16 * w, DP, rows, DP);
    tc::mma_tn<TL / 16, D / 8>(acc, ah + 16 * w, DP, rows, DP);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int o = (16 * w + g) * D + 8 * j + 2 * q4;
      *reinterpret_cast<float2*>(out + o) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + o + 8 * D) =
          make_float2(acc[j][2], acc[j][3]);
    }
  };
  if (c + 1 < nc) product(kt, ktl, vs, p.hst + (so + 1) * D * D);
  if (c > 0) product(re, rel, ys, p.gst + (so - 1) * D * D);
}

// Warp-level: a state (D x D, rows 16 w.., all columns, fp32 accumulators)
// += (scaled rows)^T . rows over nb16 blocks of 16 rows, the scaled rows
// split (hi, lo in sh, sl), the other operand exact.
template <int D>
__device__ __forceinline__ void state_rows(float (&acc)[D / 8][4],
                                           const bf16* sh, const bf16* sl,
                                           const bf16* rows, int nb16, int w) {
  constexpr int DP = D + 8;
  for (int kb = 0; kb < nb16; ++kb) {
    tc::mma_tn<1, D / 8>(acc, sl + kb * 16 * DP + 16 * w, DP,
                         rows + kb * 16 * DP, DP);
    tc::mma_tn<1, D / 8>(acc, sh + kb * 16 * DP + 16 * w, DP,
                         rows + kb * 16 * DP, DP);
  }
}

// The state fragment of rows 16 w.. as hi and lo in shared memory (D x DP)
template <int D>
__device__ __forceinline__ void store_state(const float (&acc)[D / 8][4],
                                            bf16* hi, bf16* lo, int w) {
  constexpr int DP = D + 8;
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int o = (16 * w + g) * DP + 8 * j + 2 * q4;
    uint32_t h2, l2;
    tc::split_pair(acc[j][0], acc[j][1], h2, l2);
    *reinterpret_cast<uint32_t*>(hi + o) = h2;
    *reinterpret_cast<uint32_t*>(lo + o) = l2;
    tc::split_pair(acc[j][2], acc[j][3], h2, l2);
    *reinterpret_cast<uint32_t*>(hi + o + 8 * DP) = h2;
    *reinterpret_cast<uint32_t*>(lo + o + 8 * DP) = l2;
  }
}

// Its fp32 start: a chunk-boundary state (global, D x D) decayed a row by
// exp2(x[row])
template <int D>
__device__ __forceinline__ void load_state(float (&acc)[D / 8][4],
                                           const float* src, const float* x,
                                           int w) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
  const int r0 = 16 * w + g;
  const float f0 = exp2f(x[r0]), f1 = exp2f(x[r0 + 8]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float2 a = *reinterpret_cast<const float2*>(src + r0 * D + 8 * j + 2 * q4);
    const float2 b = *reinterpret_cast<const float2*>(src + (r0 + 8) * D + 8 * j + 2 * q4);
    acc[j][0] = f0 * a.x, acc[j][1] = f0 * a.y;
    acc[j][2] = f1 * b.x, acc[j][3] = f1 * b.y;
  }
}

// Rows [0, rows) of a range of the chunk (src; its w in wr, rows past
// count read as w = 1) scaled into hi / lo by the decay to the range's far
// end (rev: the rows before the sub-tile, row s times exp2 of the lw of
// rows s + 1 .. count - 1) or from its near end (the rows after it, row t
// times exp2 of the lw of rows 0 .. t - 1); x[d] = the lw sum of the
// range.  Three rolled passes: the logs in place of w (every thread), each
// row's exponent in their place (a thread a channel, adds only), the
// scaled rows (every thread).  Every thread of the block calls it.
template <int D>
__device__ void scale_range(const bf16* src, float* wr, bf16* hi, bf16* lo,
                            int count, int rows, bool rev, float* x) {
  constexpr int DP = D + 8;
  for (int i = threadIdx.x; i < rows * D; i += SNT)
    wr[i] = i / D < count ? log2w(wr[i]) : 0.f;
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float run = 0.f;
#pragma unroll 4
    for (int k = 0; k < rows; ++k) {
      const int s = rev ? rows - 1 - k : k;
      const float l = wr[s * D + d];
      wr[s * D + d] = run;
      run += l;
    }
    x[d] = run;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += SNT) {
    const int s = i / D, d = i % D;
    store_split(hi, lo, s * DP + d,
                __bfloat162float(src[s * DP + d]) * exp2f(wr[i]));
  }
}

// (c) Each sub-tile's gradients, a block a (sub-tile, h, b).  See the
// header.
template <int D>
__global__ void __launch_bounds__(SNT, 2) wkv_sub_kernel(const TcParams p) {
  using M = SubL<D>;
  constexpr int DP = M::DP, AL = M::AL;
  constexpr int TPC = SNT / D;  // threads a channel
  constexpr int DC = D / 8;     // channels a lane in the att pairs
  static_assert(D % 16 == 0 && SNT % D == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char dsm[];
  bf16* rs = reinterpret_cast<bf16*>(dsm + M::R);
  bf16* ks = reinterpret_cast<bf16*>(dsm + M::K);
  bf16* vs = reinterpret_cast<bf16*>(dsm + M::V);
  bf16* ys = reinterpret_cast<bf16*>(dsm + M::Y);
  float* ws = reinterpret_cast<float*>(dsm + M::W);
  bf16* ra = reinterpret_cast<bf16*>(dsm + M::RA);
  bf16* rb = reinterpret_cast<bf16*>(dsm + M::RB);
  float* rw = reinterpret_cast<float*>(dsm + M::RW);
  bf16* rsh = reinterpret_cast<bf16*>(dsm + M::RS);
  bf16* rsl = reinterpret_cast<bf16*>(dsm + M::RSL);
  bf16* sh = reinterpret_cast<bf16*>(dsm + M::SH);
  bf16* sl = reinterpret_cast<bf16*>(dsm + M::SL);
  bf16* gh = reinterpret_cast<bf16*>(dsm + M::GH);
  bf16* gl = reinterpret_cast<bf16*>(dsm + M::GL);
  float* sy = reinterpret_cast<float*>(dsm + M::SY);
  float* gv = reinterpret_cast<float*>(dsm + M::GV);
  float* vy = reinterpret_cast<float*>(dsm + M::VY);
  float* ecl = reinterpret_cast<float*>(dsm + M::ECL);
  float* cls = reinterpret_cast<float*>(dsm + M::CL);
  bf16* ath = reinterpret_cast<bf16*>(dsm + M::AT);
  bf16* atl = reinterpret_cast<bf16*>(dsm + M::ATL);
  bf16* klh = reinterpret_cast<bf16*>(dsm + M::KL);
  bf16* kll = reinterpret_cast<bf16*>(dsm + M::KLL);
  float* xs = reinterpret_cast<float*>(dsm + M::VEC);  // X of S^j
  float* xg = xs + D;                                    // X of G^j
  float* gsd = xg + D;                                   // <G^j, S^j> a row
  float* us = gsd + D;
  float* dus = reinterpret_cast<float*>(dsm + M::DU);

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsub = (p.S + LS - 1) / LS, nc = (p.S + TL - 1) / TL;
  const int c = i / (TL / LS), t0 = i * LS, cs = c * TL;
  const int n = min(LS, p.S - t0);
  const int nb = t0 - cs;                            // chunk rows before
  const int na = max(0, min(cs + TL, p.S) - t0 - LS);  // and after
  const bool has_in = c > 0, has_out = c + 1 < nc;
  const bool need_s = has_in || nb > 0, need_g = has_out || na > 0;
  const long long row = (long long)p.H * D;
  const long long hb = (long long)b * p.S * row + (long long)h * D;
  const long long so = ((long long)b * p.H + h) * nc + c;

  const int na16 = (na + 15) / 16 * 16;
  copy_rows<bf16, D>(rs, DP, p.r + hb + t0 * row, row, n, LS);
  copy_rows<bf16, D>(ks, DP, p.k + hb + t0 * row, row, n, LS);
  copy_rows<bf16, D>(vs, DP, p.v + hb + t0 * row, row, n, LS);
  copy_rows<bf16, D>(ys, DP, p.dy + hb + t0 * row, row, n, LS);
  copy_rows<float, D>(ws, D, p.w + hb + t0 * row, row, n, LS);
  if (nb > 0) {  // the chunk's rows before the sub-tile: k, v, w
    copy_rows<bf16, D>(ra, DP, p.k + hb + cs * row, row, nb, nb);
    copy_rows<bf16, D>(rb, DP, p.v + hb + cs * row, row, nb, nb);
    copy_rows<float, D>(rw, D, p.w + hb + cs * row, row, nb, nb);
  }
  tc::cp_async_commit();
  for (int e = tid; e < LS * AL; e += SNT) {  // att^T: 0 where t < s
    ath[e] = __float2bfloat16(0.f);
    atl[e] = __float2bfloat16(0.f);
  }
  for (int e = tid; e < D; e += SNT) {
    us[e] = p.u[h * D + e];
    xs[e] = xg[e] = 0.f;
  }
  tc::cp_async_wait_all();
  __syncthreads();

  // the sub-tile's cumsums (every part of a channel computes them; each
  // stores its rows), k exp(cL - cl) split
  const int d = tid % D, part = tid / D;
  float cl[LS], el[LS];
  {
    float run = 0.f;
#pragma unroll
    for (int t = 0; t < LS; ++t) {
      el[t] = run;
      run += t < n ? log2w(ws[t * D + d]) : 0.f;
      cl[t] = run;
    }
#pragma unroll
    for (int t = 0; t < LS; ++t) {
      if (t % TPC != part) continue;
      ecl[t * D + d] = el[t];
      cls[t * D + d] = cl[t];
      store_split(klh, kll, t * DP + d,
                  __bfloat162float(ks[t * DP + d]) * exp2f(cl[LS - 1] - cl[t]));
    }
  }
  // S^j = diag(exp2(X)) h_in + (k before, decayed to the sub-tile's start)^T
  // v, warp w its rows 16 w..; kept in registers for <G^j, S^j>
  if (nb > 0) scale_range<D>(ra, rw, rsh, rsl, nb, nb, true, xs);
  __syncthreads();  // xs (and the cumsums above) are whole
  float sacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
  if (w < D / 16 && need_s) {
    if (has_in) load_state<D>(sacc, p.hst + so * D * D, xs, w);
    state_rows<D>(sacc, rsh, rsl, rb, nb / 16, w);
    store_state<D>(sacc, sh, sl, w);
  }
  // G^j = diag(exp2(Xg)) g_out + (r after, decayed from its end)^T dy
  if (na > 0) {
    __syncthreads();  // the rows before are read
    const long long a0 = hb + (long long)(t0 + LS) * row;
    copy_rows<bf16, D>(ra, DP, p.r + a0, row, na, na16);
    copy_rows<bf16, D>(rb, DP, p.dy + a0, row, na, na16);
    copy_rows<float, D>(rw, D, p.w + a0, row, na, na16);
    tc::cp_async_commit();
    tc::cp_async_wait_all();
    __syncthreads();
    scale_range<D>(ra, rw, rsh, rsl, na, na16, false, xg);
    __syncthreads();
  }
  if (w < D / 16) {
    float gacc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
    if (need_g) {
      if (has_out) load_state<D>(gacc, p.gst + so * D * D, xg, w);
      state_rows<D>(gacc, rsh, rsl, rb, na16 / 16, w);
      store_state<D>(gacc, gh, gl, w);
    }
    float s0 = 0.f, s1 = 0.f;  // <G^j, S^j> a row
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      s0 = fmaf(gacc[j][0], sacc[j][0], fmaf(gacc[j][1], sacc[j][1], s0));
      s1 = fmaf(gacc[j][2], sacc[j][2], fmaf(gacc[j][3], sacc[j][3], s1));
    }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    if (q4 == 0) {
      gsd[16 * w + g] = s0;
      gsd[16 * w + g + 8] = s1;
    }
  }
  // att over the pairs s <= t, as the forward: lane group tid / 8 takes
  // pairs tid / 8, tid / 8 + 16, ...; lane tid % 8 sums channels
  // [dc DC, dc DC + DC); stored transposed (att^T[s][t]) and split
  {
    constexpr int NG = SNT / 8;
    constexpr int NIT = (LS * (LS + 1) / 2 + NG - 1) / NG;
    const int dc = tid % 8, d0 = dc * DC;
    float ur[DC];
    lds<DC>(us + d0, ur);
    int t = 0, s = tid / 8;
    float a[NIT];
    int pt[NIT], ps[NIT];
#pragma unroll
    for (int it = 0; it < NIT; ++it, s += NG) {
      while (s > t) s -= ++t;
      pt[it] = t, ps[it] = s;
      a[it] = 0.f;
      if (t >= n) continue;  // past S (or past the last pair): r_t = 0
      float rr[DC], kk[DC];
      lds<DC>(rs + t * DP + d0, rr);
      lds<DC>(ks + s * DP + d0, kk);
      if (s < t) {
        float er[DC], cc[DC];
        lds<DC>(ecl + t * D + d0, er);
        lds<DC>(cls + s * D + d0, cc);
#pragma unroll
        for (int jj = 0; jj < DC; ++jj)
          a[it] = fmaf(rr[jj] * exp2f(er[jj] - cc[jj]), kk[jj], a[it]);
      } else {
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) a[it] = fmaf(rr[jj] * ur[jj], kk[jj], a[it]);
      }
    }
#pragma unroll
    for (int m = 1; m < 8; m *= 2)
#pragma unroll
      for (int it = 0; it < NIT; ++it)
        a[it] += __shfl_xor_sync(0xffffffffu, a[it], m);
#pragma unroll
    for (int it = 0; it < NIT; ++it)
      if (dc == it % 8 && pt[it] < LS)
        store_split(ath, atl, ps[it] * AL + pt[it], a[it]);
  }
  __syncthreads();  // S^j, G^j, <G, S> and att^T are whole
  // products: dy S^j^T and v G^j^T (16 columns a job), dy v^T
  {
    constexpr int NJOB = 2 * (D / 16) + 1;
    for (int job = w; job < NJOB; job += SNT / 32) {
      float acc[2][4] = {};
      if (job == NJOB - 1) {
        tc::mma_nt<D / 16, 1>(acc, ys, DP, vs, DP);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 8 * jj + 2 * q4;
          *reinterpret_cast<float2*>(vy + g * LS + col) = make_float2(acc[jj][0], acc[jj][1]);
          *reinterpret_cast<float2*>(vy + (g + 8) * LS + col) = make_float2(acc[jj][2], acc[jj][3]);
        }
        continue;
      }
      const bool is_s = job < D / 16;
      const int pn = is_s ? job : job - D / 16;
      float* out = is_s ? sy : gv;
      if (is_s ? need_s : need_g) {
        const bf16* a_rows = is_s ? ys : vs;
        tc::mma_nt2<D / 16, 1>(acc, a_rows, DP, (is_s ? sh : gh) + 16 * pn * DP,
                               (is_s ? sl : gl) + 16 * pn * DP, DP);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 16 * pn + 8 * jj + 2 * q4;
        *reinterpret_cast<float2*>(out + g * D + col) = make_float2(acc[jj][0], acc[jj][1]);
        *reinterpret_cast<float2*>(out + (g + 8) * D + col) = make_float2(acc[jj][2], acc[jj][3]);
      }
    }
  }
  // dv = att^T dy + (k exp(cL - cl)) G^j, 16 columns a job (att^T and the
  // scaled k split; G^j split: hi.hi + hi.lo + lo.hi)
  {
    bf16* dvg = p.dv + hb + t0 * row;
    for (int pn = w; pn < D / 16; pn += SNT / 32) {
      float acc[2][4] = {};
      tc::mma_nn<1, 1>(acc, atl, AL, ys + 16 * pn, DP);
      tc::mma_nn<1, 1>(acc, ath, AL, ys + 16 * pn, DP);
      if (need_g) {
        tc::mma_nn<D / 16, 1>(acc, kll, DP, gh + 16 * pn, DP);
        tc::mma_nn<D / 16, 1>(acc, klh, DP, gl + 16 * pn, DP);
        tc::mma_nn<D / 16, 1>(acc, klh, DP, gh + 16 * pn, DP);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 16 * pn + 8 * jj + 2 * q4;
        if (g < n)
          *reinterpret_cast<uint32_t*>(dvg + g * row + col) =
              tc::pack_bf16(acc[jj][0], acc[jj][1]);
        if (g + 8 < n)
          *reinterpret_cast<uint32_t*>(dvg + (g + 8) * row + col) =
              tc::pack_bf16(acc[jj][2], acc[jj][3]);
      }
    }
  }
  __syncthreads();  // sy, gv, vy are whole
  // a thread a (channel d, part): rows t = part, part + TPC, ...
  {
    float rr[LS], kk[LS];
#pragma unroll
    for (int t = 0; t < LS; ++t) {
      rr[t] = __bfloat162float(rs[t * DP + d]);
      kk[t] = __bfloat162float(ks[t * DP + d]);
    }
    const float ud = us[d], gs = gsd[d];
    const float cL = cl[LS - 1];
    float du_acc = 0.f;
    const long long ob = hb + t0 * row + d;
#pragma unroll
    for (int t = 0; t < LS; ++t) {
      if (t % TPC != part || t >= n) continue;  // rows past S are zero
      const float vyd = vy[t * LS + t];
      float as[LS];
      float dra = 0.f, dw2 = 0.f;
#pragma unroll
      for (int s = 0; s < t; ++s) {
        as[s] = exp2f(el[t] - cl[s]) * kk[s];
        dra = fmaf(as[s], vy[t * LS + s], dra);
        dw2 = fmaf(as[s], gv[s * D + d], dw2);
      }
      float dka = 0.f, dw3 = 0.f, dw4 = 0.f;
#pragma unroll
      for (int tau = t + 1; tau < LS; ++tau) {
        const float rb_ = exp2f(el[tau] - cl[t]) * rr[tau];
        dka = fmaf(rb_, vy[tau * LS + t], dka);
        dw3 = fmaf(rb_, sy[tau * D + d], dw3);
        float inner = 0.f;
#pragma unroll
        for (int s = 0; s < t; ++s) inner = fmaf(as[s], vy[tau * LS + s], inner);
        dw4 = fmaf(rb_, inner, dw4);
      }
      const float tail = exp2f(cL - cl[t]), head = exp2f(el[t]);
      du_acc = fmaf(rr[t] * kk[t], vyd, du_acc);
      const float wr = ws[t * D + d];
      const bool inside = wr >= W_MIN && wr <= 1.f;
      p.dr[ob + t * row] = __float2bfloat16(
          fmaf(head, sy[t * D + d], dra) + ud * kk[t] * vyd);
      p.dk[ob + t * row] = __float2bfloat16(
          fmaf(tail, gv[t * D + d], dka) + rr[t] * ud * vyd);
      p.dw[ob + t * row] =
          inside ? tail * head * gs + tail * dw2 + head * dw3 + dw4 : 0.f;
    }
    dus[tid] = du_acc;
  }
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
#pragma unroll
    for (int pp = 0; pp < TPC; ++pp) s += dus[pp * D + tid];
    if (p.B * nsub == 1)
      p.du[h * D + tid] = s;
    else
      p.du[(((long long)b * nsub + i) * p.H + h) * D + tid] = s;
  }
}

template <typename K>
cudaError_t tc_launch_with(K kernel, size_t smem, dim3 grid, int threads,
                           const TcParams& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t tc_launch(const TcParams& p, float* du, cudaStream_t st) {
  const int nc = (p.S + TL - 1) / TL, nsub = (p.S + LS - 1) / LS;
  cudaError_t err;
  if (nc > 1) {
    if ((err = tc_launch_with(wkv_sum_kernel<D>, SumL<D>::BYTES,
                              dim3(nc, p.H, p.B), TNT, p, st)) != cudaSuccess)
      return err;
    if (nc > 2) {
      scan_chunks_kernel<<<dim3((D * D + 255) / 256, p.B * p.H), 256, 0,
                            st>>>(p.hst, p.gst, p.dec, nc, D * D, D);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  if ((err = tc_launch_with(wkv_sub_kernel<D>, SubL<D>::BYTES,
                            dim3(nsub, p.H, p.B), SNT, p, st)) != cudaSuccess)
    return err;
  if (p.B * nsub > 1) {
    const int m = p.B * nsub, n = p.H * D;
    sum_rows_kernel<<<(n + 255) / 256, 256, 0, st>>>(p.du, du, m, n);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// The fp32 kernel.  Scratch the wrapper allocates: ckpt B H ceil(S / 64) D^2
// floats, seg B H (64 D^2 / 16384) D^2 and du_part B H D.  Every tensor is
// contiguous: r, k, v, w, dy, dr, dk, dv, dw (B, S, H, D); u, du (H, D).
// dtype 0 is float32.  Returns the first failing launch's
// cudaGetLastError() (0 on success).
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
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The bf16 kernels.  Scratch the wrapper allocates (wkv6_scan.bwd_scratch):
// du_part B ceil(S / 16) H D floats (used when B S > 16), hst and gst B H
// ceil(S / 64) D^2 and dec B H ceil(S / 64) D (used when S > 64).  Shapes
// and contiguity as above, r, k, v, dy, dr, dk, dv bfloat16; r, k, v, w, dy
// 16-byte aligned.  Returns the first failing launch's cudaGetLastError()
// (0 on success).
extern "C" int wkv6_scan_bwd_tc(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* dy,
                                void* dr, void* dk, void* dv, void* dw,
                                void* du, void* du_part, void* hst, void* gst,
                                void* dec, int B, int S, int H, int D,
                                void* stream) {
  if (!(aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
        aligned16(dy)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int nsub = (S + LS - 1) / LS;
  TcParams p{static_cast<const bf16*>(r), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<const float*>(w),
             static_cast<const float*>(u), static_cast<const bf16*>(dy),
             static_cast<bf16*>(dr), static_cast<bf16*>(dk),
             static_cast<bf16*>(dv), static_cast<float*>(dw),
             static_cast<float*>(B * nsub == 1 ? du : du_part),
             static_cast<float*>(hst), static_cast<float*>(gst),
             static_cast<float*>(dec), B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* duf = static_cast<float*>(du);
  cudaError_t err;
  switch (D) {
    case 16: err = tc_launch<16>(p, duf, st); break;
    case 32: err = tc_launch<32>(p, duf, st); break;
    case 64: err = tc_launch<64>(p, duf, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* wkv6_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
