// Forward flash attention for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 on the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel (called by
// flash_attention() there): softmax(mask(softcap(scale * Q K^T))) V with an
// online softmax (running max m, normaliser l clamped at 1e-30, fp32
// accumulator), masks kpos < T, causal qpos >= kpos with qpos = q_pos0 + row,
// and window qpos - kpos < window; GQA maps query head h to KV head
// h / (H / KV).  Layout: q, o (B,S,H,D) and k, v (B,T,KV,D), contiguous.
//
// The TPU grid (B, H, S/bq, T/bk) ran its KV axis in order on one core,
// carrying m/l/acc in VMEM.  Blocks of a GPU run in no order, so here one
// block owns one (b, h, 64-row query tile) and walks the KV axis itself.
// KV tiles that are masked for every row of the query tile (beyond the
// causal diagonal, or before the window) are skipped, which is equivalent:
// a row's first real key resets it through corr = exp(-1e30 - m) = 0, as in
// the reference.  Masked logits are the finite -1e30, never -inf.
//
// The entry point picks the kernel by dtype (a dispatch by type, not a
// fallback: no path retries another kernel after a failure):
//
// bf16 (dtype 1): FlashAttention-2 on mma.sync (flash_fwd_bf16_kernel).
//   * 4 warps, each owning 16 of the tile's 64 query rows; the Q fragments
//     are loaded once with ldmatrix and stay in registers for the KV loop.
//   * S = Q K^T per 64-key tile on mma.sync.m16n8k16 (bf16 in, fp32 sum);
//     scale, softcap, masks and the online softmax run on the fp32
//     accumulator fragments, in log2 units (the scale times log2 e), so
//     each exponential is one ex2; row max and sum are two quad shuffles.
//   * P is rounded to bf16 in registers and is the A operand of P V as it
//     stands (tc_ptx.cuh: the C layout of two n-tiles is the A layout).
//   * K/V tiles are bf16 in shared memory, loaded with 16-byte cp.async
//     into two stages: tile j+1 loads while tile j computes.  Rows are
//     padded to D+8 elements, so ldmatrix (and ldmatrix.trans for V) reads
//     8 rows from 8 different 16-byte bank groups.
//   * Under causal masking the query tiles are launched heaviest first
//     (the tile index is the grid's slowest axis, reversed).
//   Two numerics differ from the Pallas body: it scales q in fp32 before
//   the product (flash_attention.py:39), this kernel multiplies the fp32
//   logits by the scale (rounding a scaled q to bf16 would add error); and
//   it keeps P in fp32 for P V (:63-64), this kernel rounds P to bf16 (l
//   sums the unrounded P).  ref.flash_attention_tc_ref mirrors both.
//
// fp32 (dtype 0): scalar fp32 FMAs (flash_fwd_f32_kernel), the design of the
//   first port: 128 threads as a 16 x 8 grid, 4 rows x 8 keys of the score
//   tile each, Q/K/V and P staged in shared memory as fp32.  TF32 would
//   miss the fp32 bar (atol 2e-5, rtol 1e-3), so fp32 stays off the tensor
//   cores; it serves fp32 callers and float32-compute runs.
//
// What bounds it on an H100.  At the main path's shapes (jag: B=4, H=4;
// zamba2: B=4, H=32; S=T=512, D=64, bf16, causal) the work is 0.54 / 4.3
// GFLOP over 4 / 34 MB of q/k/v/o: the card's floor is the memory term
// (1.3 / 10 us at 3.35 TB/s), and the tensor-core term (989 TFLOP/s) only
// once S passes a few thousand.  The kernel is bound by latency: at most 8
// KV tiles a block, each a chain of ldmatrix -> mma -> softmax -> mma, and
// at jag's shape only B*H*S/64 = 128 blocks of 4 warps (one wave under 132
// SMs).  Splitting the KV axis across blocks with a combine pass is the
// later fix for small grids; wgmma with TMA and a producer warp the later
// fix for long sequences.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_ptx.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int TY = 16;        // thread grid rows
constexpr int TX = 8;         // thread grid columns (one row's owners)
constexpr int NT = TY * TX;   // threads per block
constexpr int RQ = BQ / TY;   // query rows per thread
constexpr int CK = BK / TX;   // keys per thread
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(const Params p) {
  using T = float;
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
    Qs[r * (D + 1) + c] = s < p.S ? qb[s * q_row + c] * p.scale : 0.f;
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
      Ks[r * (D + 1) + c] = in ? kb[t * kv_row + c] : 0.f;
      Vs[r * D + c] = in ? vb[t * kv_row + c] : 0.f;
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
      ob[s * q_row + tx + TX * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int NW = BQ / 16;  // warps, 16 query rows each
static_assert(NW * 32 == NT, "the bf16 kernel runs NT threads as NW warps");

template <int D>
constexpr size_t smem_bytes_bf16() {  // Q tile, then K and V in two stages
  return sizeof(__nv_bfloat16) * (BQ + 4 * BK) * (D + 8);
}

// rows [row0, row0 + rows) x D of a (rows, D) tile with row stride `stride`
// elements into shared memory with rows of LD elements; rows past `limit`
// are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int rows, int limit) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int t = row0 + r;
    const bool in = t < limit;
    tc::cp_async16(dst + r * LD + c, src + (in ? t : 0) * stride + c, in);
  }
}

// 4 blocks an SM (<= 128 registers a thread) up to D = 64, 2 at D = 128.
template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 4 : 2)
    flash_fwd_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;    // padded shared-memory row
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;   // n-tiles of the score tile
  constexpr int ND = D / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* Ks = Qs + BQ * LD;                       // 2 stages of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                   // 2 stages of BK x LD

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int nq = (p.S + BQ - 1) / BQ;
  const int q0 = (p.causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (p.H / p.KV);

  const long long q_row = (long long)p.H * D;
  const long long kv_row = (long long)p.KV * D;
  const bf16* qb = static_cast<const bf16*>(p.q) + (long long)b * p.S * q_row +
                   (long long)h * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + (long long)b * p.T * kv_row +
                   (long long)kvh * D;
  const bf16* vb = static_cast<const bf16*>(p.v) + (long long)b * p.T * kv_row +
                   (long long)kvh * D;
  bf16* ob = static_cast<bf16*>(p.o) + (long long)b * p.S * q_row +
             (long long)h * D;

  const int q_last = min(q0 + BQ, p.S) - 1;
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, p.q_pos0 + q_last + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, p.q_pos0 + q0 - p.window + 1);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  load_tile<D, LD>(Qs, qb, q_row, q0, BQ, p.S);
  if (n_tiles > 0) {
    load_tile<D, LD>(Ks, kb, kv_row, k_lo, BK, p.T);
    load_tile<D, LD>(Vs, vb, kv_row, k_lo, BK, p.T);
  }
  tc::cp_async_commit();

  const float scale_log2 = p.scale * LOG2E;
  // this thread's two rows of the tile: r0 = 16 * warp + g and r0 + 8
  const int r0 = 16 * warp + g;
  const int qpos0 = p.q_pos0 + q0 + r0;
  uint32_t qf[KD][4];
  float o[ND][4];
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_lo + j * BK;
    tc::cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < n_tiles) {  // the stage tile j - 1 used
      bf16* kd = Ks + ((j + 1) & 1) * BK * LD;
      bf16* vd = Vs + ((j + 1) & 1) * BK * LD;
      load_tile<D, LD>(kd, kb, kv_row, k0 + BK, BK, p.T);
      load_tile<D, LD>(vd, vb, kv_row, k0 + BK, BK, p.T);
      tc::cp_async_commit();
    }
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldsm_x4(qf[kk], Qs + (16 * warp + lane % 16) * LD + kk * 16 +
                                (lane / 16) * 8);
    }
    const bf16* Kt = Ks + (j & 1) * BK * LD;
    const bf16* Vt = Vs + (j & 1) * BK * LD;

    // S = Q K^T: two n-tiles (16 keys) per ldmatrix.x4 of K
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        tc::ldsm_x4(kf, Kt + (np * 16 + (lane / 16) * 8 + lane % 8) * LD +
                            kk * 16 + ((lane / 8) % 2) * 8);
        tc::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // scale, softcap, mask, in log2 units (x log2 e) so that each
    // exponential is one ex2; the row max over the quad
    const bool masked = k0 + BK > p.T ||
                        (p.causal && k0 + BK - 1 > p.q_pos0 + q0) ||
                        (p.window > 0 && p.q_pos0 + q0 + BQ - 1 - k0 >= p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * scale_log2;
        if (p.softcap > 0.f)
          x = p.softcap * LOG2E * tanhf(s[n][c] * p.scale / p.softcap);
        if (masked) {
          const int qpos = qpos0 + (c / 2) * 8;
          const int kpos = k0 + n * 8 + 2 * q4 + (c % 2);
          bool keep = kpos < p.T;
          if (p.causal) keep = keep && qpos >= kpos;
          if (p.window > 0) keep = keep && (qpos - kpos) < p.window;
          x = keep ? x : NEG_INF;
        }
        s[n][c] = x;
        mx[c / 2] = fmaxf(mx[c / 2], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = exp2f(s[n][c] - m[c / 2]);
        s[n][c] = e;
        rs[c / 2] += e;
      }
    // l sums this thread's columns; the quad's partial sums meet at the end
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t pa[4] = {
          tc::pack_bf16(s[2 * ks][0], s[2 * ks][1]),
          tc::pack_bf16(s[2 * ks][2], s[2 * ks][3]),
          tc::pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          tc::pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        tc::ldsm_x4_trans(vf, Vt + (ks * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                       LD + dp * 16 + (lane / 16) * 8);
        tc::mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  tc::cp_async_wait_all();  // nothing in flight at exit (n_tiles == 0: Q)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int srow = q0 + r0 + 8 * i;
    if (srow >= p.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(ob + srow * q_row + n * 8 + 2 * q4) =
          tc::pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
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
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  const int nq = (p.S + BQ - 1) / BQ;
  if (dtype == 1)  // query tile slowest, so heavy causal tiles go first
    return launch_with(flash_fwd_bf16_kernel<D>, smem_bytes_bf16<D>(),
                       dim3(p.H, p.B, nq), p, stream);
  return launch_with(flash_fwd_f32_kernel<D>, smem_bytes<D>(),
                     dim3(nq, p.H, p.B), p, stream);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success).  The caller has
// checked shapes, dtype and contiguity; dtype 0 is float32, 1 is bfloat16.
// The bf16 kernel copies 16-byte chunks, so its pointers must be 16-byte
// aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int T, int H, int KV,
                                   int D, int dtype, float scale,
                                   float softcap, int causal, int window,
                                   int q_pos0, void* stream) {
  Params p{q, k, v, o, B, S, T, H, KV, scale, softcap, causal, window, q_pos0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && !(aligned16(q) && aligned16(k) && aligned16(v) &&
                      aligned16(o)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(p, dtype, st); break;
    case 32: err = launch<32>(p, dtype, st); break;
    case 64: err = launch<64>(p, dtype, st); break;
    case 128: err = launch<128>(p, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
