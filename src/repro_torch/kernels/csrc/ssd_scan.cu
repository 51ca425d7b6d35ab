// Mamba2 SSD scan for Hopper (sm_90a): bf16 x/B/C with the products on the
// tensor cores, or fp32 x/B/C on the CUDA cores; fp32 dt and A, fp32 state
// and accumulation, output in x's dtype.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:_kernel (called by
// ssd_scan() there).  Per (b, h), with acs = cumsum(A dt) over a tile of time
// and a (P, N) fp32 state h carried from tile to tile:
//   W[t,s]  = (C_t . B_s) exp(acs_t - acs_s) dt_s                 (s <= t)
//   y[t,:]  = W[t,:] . x + exp(acs_t) (C_t . h^T)
//   h      <- exp(acs_L) h + (x * (exp(acs_L - acs) dt))^T B
// A < 0 and dt > 0, so acs falls along time and every exponential is taken
// of an exponent <= 0: nothing overflows.  Layout: x, y (B,S,H,P); dt
// (B,S,H); A (H,); B, C (B,S,N), shared by heads; contiguous.
//
// The Pallas grid (B, H, S/chunk) ran its chunk axis in order on one core,
// carrying h in VMEM, with chunk x chunk tiles on the MXU.  Blocks of a GPU
// run in no order, so a block walks time itself, in 64-row tiles whatever
// the wrapper's `chunk` (only its padding unit): chunking is exact, so the
// result equals the chunked algorithm (ref.ssd_chunked_ref) at any chunk up
// to rounding.  A ragged last tile (S = 200 is 3 x 64 + 8) is zero-filled
// past S: its rows have dt = 0, so they add nothing to acs, W or the state,
// and they are not stored.
//
// What bounds it on an H100.  At zamba2's prefill (B=4, S=512, H=64, P=N=64,
// bf16) the bytes (x and y in bf16, dt in fp32, B and C in bf16, each once)
// are 34.6 MB, 10.3 us at 3.35 TB/s, and the algorithm's products (C B^T, W
// x, C h^T, the state update) 3.3 GFLOP, 3.3 us on the tensor cores: the
// card's floor is the memory.  PR 12's kernel, kept below as the fp32 path,
// reached 44x that: scalar FMAs with both operands from shared memory, about
// 7k shared loads a thread a tile, so the shared-memory pipe bound it.  A
// tile is a chain of dependent steps (copy, cumsum, products, state), so
// what bounds this design is latency: the 16 warps an SM holds and the
// number of tiles a block walks in order.
//
// Design of the bf16 kernel (ssd_tc_kernel):
//   * A block owns one (b, h): 256 blocks of 8 warps at zamba2's prefill,
//     2 an SM (~100 KB of shared memory each), one wave.  Its warps are two
//     column groups (32 of P's 64 columns each) of 4 warps, each warp
//     owning 16 of the tile's rows; P <= 32 is one group.  Each
//     group recomputes C B^T and W for its columns; B, C and dt are copied
//     once a head (a block per half-head, 4 an SM, copied them twice and
//     ran slower).
//   * The next tile's x, B, C (16-byte cp.async, rows padded by 8 bf16 so
//     ldmatrix is conflict-free) and dt (4-byte cp.async: dt lies at a
//     stride of H floats) are copied while this tile computes.
//   * acs is kept in log2 units (one ex2 per exponential), a scan over the
//     warp's shuffles, done by every warp for itself: lane l holds rows 2l
//     and 2l+1, and a fragment gets acs_s and dt_s by shuffle, so no barrier
//     guards it.
//   * Every product is mma.sync.m16n8k16 (bf16 in, fp32 accumulators; see
//     tc_ptx.cuh):
//       - y = exp2(acs_t) (C h^T) first, then + W x;
//       - W is made 16 columns s at a time in accumulators (C B^T, both
//         operands the exact bf16 inputs), scaled and masked there, and fed
//         as the A operand of W x from registers; blocks above the
//         diagonal are skipped, so the warp of rows 16w.. does w + 1 of
//         them (the groups take the rows in opposite orders, so every SM
//         sub-partition issues the same number).  Below the
//         diagonal every t lies past the column block's last row e, so
//         exp2(acs_t - acs_s) = exp2(acs_t - acs_e) exp2(acs_e - acs_s),
//         both exponents <= 0 (no clamp): 2 ex2 a thread a block instead
//         of 16; the diagonal block is taken pairwise;
//       - the state update x^T (tail * B), with tail * B written to shared
//         memory once a tile, is split over a group's warps by (16 state
//         rows, 8-column tiles of N).  h stays in those fp32 accumulators
//         from tile to tile, decayed by exp2(acs_L) before each update, and
//         is written to shared memory once a tile as the B operand of the
//         next tile's C h^T;
//       - y goes through shared memory and out as 16-byte rows.
//   * Rounding: every fp32 operand (W, tail * B, h) is split into hi =
//     bf16(v) and lo = bf16(v - hi); x, B and C are bf16 already, so a
//     product is hi.b + lo.b, 2 mma, with the lo products of y summed in
//     accumulators of their own (~16 mantissa bits, the Pallas body's fp32
//     to within ~2^-17).  Plain bf16 operands in PR 13's WKV6 design moved
//     rwkv6-3b's served logits past their bar.  ref.ssd_subtile_ref mirrors
//     every rounding point.
//   * Two barriers a tile: one when the tile has landed (which also orders
//     the last tile's state write before this tile's C h^T), one between
//     the last read of h and its update.
//
// The fp32 kernel (ssd_f32_kernel, dtype 0, the float32-compute check run
// only) is PR 12's: one block of 256 threads per (b, h), x, B, C, W, the
// state and the cumsum in shared memory as fp32, scalar FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_ptx.cuh"

namespace {

constexpr int L = 64;  // time rows per tile

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  int B, S, H;
};

// ---------------------------------------------------------------------------
// fp32: scalar FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int NT32 = 256;  // threads per block

template <int P, int N>
constexpr size_t smem_bytes_f32() {
  // x; B padded; C; h padded; W; dt, acs, tail
  return sizeof(float) *
         (L * P + L * (N + 1) + L * N + P * (N + 1) + L * L + 3 * L);
}

template <int P, int N>
__global__ void __launch_bounds__(NT32) ssd_f32_kernel(const Params p) {
  constexpr int NT = NT32;
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
  const float* xg = static_cast<const float*>(p.x) +
                    (long long)b * p.S * xrow + (long long)h * P;
  float* yg = static_cast<float*>(p.y) + (long long)b * p.S * xrow +
              (long long)h * P;
  const float* dtg = p.dt + (long long)b * p.S * p.H + h;
  const float* bg = static_cast<const float*>(p.Bm) + (long long)b * p.S * N;
  const float* cg = static_cast<const float*>(p.Cm) + (long long)b * p.S * N;

  for (int i = tid; i < P * NP; i += NT) hs[i] = 0.f;

  const int py = tid % P, gy = tid / P;  // y product: column, row group
  const int nh = tid % N, gh = tid / N;  // state update: column, row group

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int n = min(L, p.S - t0);  // rows in this tile
    __syncthreads();  // last tile's reads of the tile buffers are done
    for (int i = tid; i < n * P; i += NT) {
      const int t = i / P, c = i % P;
      xs[i] = xg[(long long)(t0 + t) * xrow + c];
    }
    for (int i = tid; i < n * N; i += NT) {
      const int t = i / N, c = i % N;
      const long long off = (long long)(t0 + t) * N + c;
      bs[t * NP + c] = bg[off];
      cs[i] = cg[off];
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
      yg[(long long)(t0 + t) * xrow + py] = intra + expf(acs[t]) * ch;
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

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// The bf16 kernel's shapes and shared memory (in bytes from the start; every
// piece is a multiple of 16 bytes, and rows read by ldmatrix are padded by 8
// bf16).  A block owns one (b, h); its warps are column groups of PC of P's
// columns times 4 warps of 16 rows each.
template <int P, int N>
struct Tc {
  static constexpr int PC = P < 32 ? P : 32;  // columns of a column group
  static constexpr int NT = 128 * (P / PC);   // threads per block
  static constexpr int XP = P + 8;   // x rows
  static constexpr int NP = N + 8;   // B, C and state rows
  // one of the two stages of the prefetched tile: x, B, C (bf16), dt (fp32)
  static constexpr int X = 0;
  static constexpr int BM = X + L * XP * 2;
  static constexpr int CM = BM + L * NP * 2;
  static constexpr int DT = CM + L * NP * 2;
  static constexpr int STAGE = DT + L * 4;
  // the state h (P x N) and tail * B (L x N), each as bf16 hi and lo;
  // the tile's y (L x P), stored to device memory by rows
  static constexpr int HI = 2 * STAGE;
  static constexpr int LO = HI + P * NP * 2;
  static constexpr int TB = LO + P * NP * 2;
  static constexpr int TB_LO = TB + L * NP * 2;
  static constexpr int Y = TB_LO + L * NP * 2;
  static constexpr int BYTES = Y + L * XP * 2;
  // 16 warps an SM (128 registers a thread) where the shared memory fits
  // them (228 KB, 1 KB reserved per block)
  static constexpr int MIN_BLOCKS =
      512 / NT * (BYTES + 1024) <= 228 * 1024 ? 512 / NT : 1;
};

// (v0, v1) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = tc::pack_bf16(v0 - hf.x, v1 - hf.y);
}

// a bf16 pair times a, split
__device__ __forceinline__ void scale_split2(uint32_t v, float a, uint32_t& hi,
                                             uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split2(f.x * a, f.y * a, hi, lo);
}

template <int P, int N>
__global__ void __launch_bounds__(Tc<P, N>::NT, Tc<P, N>::MIN_BLOCKS)
    ssd_tc_kernel(const Params p) {
  using M = Tc<P, N>;
  constexpr int PC = M::PC, NT = M::NT, XP = M::XP, NP = M::NP;
  constexpr int NX = PC / 8;       // 8-column tiles of y
  // the state's fragment tiles in a column group: MT row tiles of 16, SN
  // column tiles of 8; warp w takes row tile w % MT and column tiles
  // w / MT + WM i
  constexpr int MT = PC / 16, WM = 4 / MT, SN = N / 8;
  constexpr int NJ = (SN + WM - 1) / WM;
  static_assert(PC % 16 == 0 && N % 16 == 0 && 4 % MT == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::HI);
  __nv_bfloat16* hs_lo = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::LO);
  __nv_bfloat16* tb = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::TB);
  __nv_bfloat16* tb_lo = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::TB_LO);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw + M::Y);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32 % 4;  // warp in its group
  // the warp's row tile: the second column group takes them in reverse, so
  // the two warps that share an SM sub-partition (warp ids w and w + 4) do
  // w + 1 and 4 - w of the causal blocks of W, 5 in all on each
  const int rw = tid / 128 % 2 ? 3 - warp : warp;
  const int g = lane / 4, q4 = lane % 4;
  const int p0 = tid / 128 * PC;  // the column group's first column
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a2 = p.A[h] * LOG2E;  // A in log2 units
  const long long xrow = (long long)p.H * P;  // stride of s in x and y
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) +
                            (long long)b * p.S * xrow + h * P;
  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(p.y) +
                      (long long)b * p.S * xrow + h * P;
  const float* dtg = p.dt + (long long)b * p.S * p.H + h;
  const __nv_bfloat16* bg =
      static_cast<const __nv_bfloat16*>(p.Bm) + (long long)b * p.S * N;
  const __nv_bfloat16* cg =
      static_cast<const __nv_bfloat16*>(p.Cm) + (long long)b * p.S * N;

  for (int i = tid; i < P * NP; i += NT) {
    hs[i] = __float2bfloat16(0.f);
    hs_lo[i] = __float2bfloat16(0.f);
  }
  float sacc[NJ][4];  // h: rows 16 mt + g (+8), columns 8 j + 2 q4 (+1)
#pragma unroll
  for (int i = 0; i < NJ; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) sacc[i][c] = 0.f;
  const int mt = warp % MT, jw = warp / MT;

  // rows [t0, t0 + L) into a stage; rows past S are zero-filled
  auto prefetch = [&](int t0, int stage) {
    unsigned char* sb = smem_raw + stage * M::STAGE;
    constexpr int CX = P * 2 / 16, CN = N * 2 / 16;  // 16-byte chunks a row
    for (int i = tid; i < L * CX; i += NT) {
      const int t = i / CX, c = i % CX;
      const bool in = t0 + t < p.S;
      const __nv_bfloat16* src = xg + (in ? t0 + t : 0) * xrow + 8 * c;
      tc::cp_async16(sb + M::X + (t * XP + 8 * c) * 2, src, in);
    }
    for (int i = tid; i < L * CN; i += NT) {
      const int t = i / CN, c = i % CN;
      const bool in = t0 + t < p.S;
      const long long off = (long long)(in ? t0 + t : 0) * N + 8 * c;
      tc::cp_async16(sb + M::BM + (t * NP + 8 * c) * 2, bg + off, in);
      tc::cp_async16(sb + M::CM + (t * NP + 8 * c) * 2, cg + off, in);
    }
    if (tid < L) {
      const bool in = t0 + tid < p.S;
      tc::cp_async4(sb + M::DT + tid * 4,
                    dtg + (long long)(in ? t0 + tid : 0) * p.H, in);
    }
    tc::cp_async_commit();
  };

  const int r0 = 16 * rw + g, r1 = r0 + 8;  // this thread's rows of y
  const int ntiles = (p.S + L - 1) / L;
  prefetch(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * L;
    const int n = min(L, p.S - t0);  // rows in this tile
    const unsigned char* sb = smem_raw + (it & 1) * M::STAGE;
    using bf16 = __nv_bfloat16;
    const bf16* xs = reinterpret_cast<const bf16*>(sb + M::X);
    const bf16* bs = reinterpret_cast<const bf16*>(sb + M::BM);
    const bf16* cs = reinterpret_cast<const bf16*>(sb + M::CM);
    const float* dts = reinterpret_cast<const float*>(sb + M::DT);
    tc::cp_async_wait_all();
    __syncthreads();  // tile it landed; the state of tile it - 1 is stored
    if (it + 1 < ntiles) prefetch(t0 + L, (it + 1) & 1);

    // 1. acs over the tile in log2 units, every warp for itself: this lane
    //    holds rows 2 lane and 2 lane + 1 (dt = 0 past S, so acs_L = acs at
    //    row 63 is acs at the last real row)
    const float d0 = dts[2 * lane], d1 = dts[2 * lane + 1];
    const float e0 = a2 * d0, e1 = a2 * d1;
    float run = e0 + e1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run += o;
    }
    const float c1 = run, c0 = run - e1;  // acs at rows 2 lane + 1, 2 lane
    const float acs_last = __shfl_sync(0xffffffffu, c1, 31);
    const float tl0 = exp2f(acs_last - c0) * d0;  // tail weights
    const float tl1 = exp2f(acs_last - c1) * d1;
    // column factors of W below the diagonal: exp2(e_k - acs_s) dt_s, with
    // e_k the acs of the last row of s's 16-row block (exponent <= 0)
    const float eb = __shfl_sync(0xffffffffu, c1, lane | 7);
    const float cf0 = exp2f(eb - c0) * d0, cf1 = exp2f(eb - c1) * d1;
    // tail * B, once a block, as hi and lo: 8 columns of one row a step
    for (int i = tid; i < L * N / 8; i += NT) {
      const int s = i / (N / 8), c = 8 * (i % (N / 8));
      const float u0 = __shfl_sync(0xffffffffu, tl0, s / 2);
      const float u1 = __shfl_sync(0xffffffffu, tl1, s / 2);
      const float tail = (s & 1) ? u1 : u0;
      const uint4 v = *reinterpret_cast<const uint4*>(bs + s * NP + c);
      uint4 hi, lo;
      scale_split2(v.x, tail, hi.x, lo.x);
      scale_split2(v.y, tail, hi.y, lo.y);
      scale_split2(v.z, tail, hi.z, lo.z);
      scale_split2(v.w, tail, hi.w, lo.w);
      *reinterpret_cast<uint4*>(tb + s * NP + c) = hi;
      *reinterpret_cast<uint4*>(tb_lo + s * NP + c) = lo;
    }
    float at0, at1;  // acs at rows r0, r1
    {
      const int src = 8 * rw + g / 2;
      const float u0 = __shfl_sync(0xffffffffu, c0, src);
      const float u1 = __shfl_sync(0xffffffffu, c1, src);
      const float v0 = __shfl_sync(0xffffffffu, c0, src + 4);
      const float v1 = __shfl_sync(0xffffffffu, c1, src + 4);
      at0 = (g & 1) ? u1 : u0;
      at1 = (g & 1) ? v1 : v0;
    }

    // 2. y = exp2(acs_t) (C h^T) + W x; hi products and lo products in
    //    accumulators of their own
    float ya[NX][4], yl[NX][4];
#pragma unroll
    for (int j = 0; j < NX; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) ya[j][c] = yl[j][c] = 0.f;
    const bf16* crow = cs + (16 * rw + lane % 16) * NP + (lane / 16) * 8;
#pragma unroll
    for (int kc = 0; kc < N / 16; ++kc) {
      uint32_t a[4];
      tc::ldsm_x4(a, crow + 16 * kc);
#pragma unroll
      for (int pn = 0; pn < NX / 2; ++pn) {
        const int hrow = (p0 + 16 * pn + lane % 8 + (lane / 16) * 8) * NP +
                         16 * kc + ((lane / 8) % 2) * 8;
        uint32_t bh[4], bl[4];
        tc::ldsm_x4(bh, hs + hrow);
        tc::ldsm_x4(bl, hs_lo + hrow);
        tc::mma_bf16(yl[2 * pn], a, bl[0], bl[1]);
        tc::mma_bf16(yl[2 * pn + 1], a, bl[2], bl[3]);
        tc::mma_bf16(ya[2 * pn], a, bh[0], bh[1]);
        tc::mma_bf16(ya[2 * pn + 1], a, bh[2], bh[3]);
      }
    }
    {
      const float f0 = exp2f(at0), f1 = exp2f(at1);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        ya[j][0] *= f0, ya[j][1] *= f0, ya[j][2] *= f1, ya[j][3] *= f1;
        yl[j][0] *= f0, yl[j][1] *= f0, yl[j][2] *= f1, yl[j][3] *= f1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // columns s = 16 kk .. 16 kk + 15
      if (kk > rw) break;             // above the diagonal: W = 0
      float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16* brow = bs + (16 * kk + lane % 8 + (lane / 16) * 8) * NP +
                         ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kc = 0; kc < N / 16; ++kc) {
        uint32_t a[4], bb[4];
        tc::ldsm_x4(a, crow + 16 * kc);
        tc::ldsm_x4(bb, brow + 16 * kc);
        tc::mma_bf16(cb[0], a, bb[0], bb[1]);
        tc::mma_bf16(cb[1], a, bb[2], bb[3]);
      }
      // W = C B^T exp2(acs_t - acs_s) dt_s for s <= t, else 0.  Below the
      // diagonal block every t is past the block's last row, so the
      // exponential factors through it into a row and a column factor,
      // both exponents <= 0; on the diagonal it is taken pairwise.
      if (kk < rw) {
        const float ek = __shfl_sync(0xffffffffu, c1, 8 * kk + 7);
        const float f0 = exp2f(at0 - ek), f1 = exp2f(at1 - ek);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int src = 8 * kk + 4 * jj + q4;  // the lane holding s, s + 1
          const float g0 = __shfl_sync(0xffffffffu, cf0, src);
          const float g1 = __shfl_sync(0xffffffffu, cf1, src);
          float* w = cb[jj];
          w[0] *= f0 * g0, w[1] *= f0 * g1, w[2] *= f1 * g0, w[3] *= f1 * g1;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int src = 8 * kk + 4 * jj + q4;
          const float as0 = __shfl_sync(0xffffffffu, c0, src);
          const float as1 = __shfl_sync(0xffffffffu, c1, src);
          const float ds0 = __shfl_sync(0xffffffffu, d0, src);
          const float ds1 = __shfl_sync(0xffffffffu, d1, src);
          const int s0 = 16 * kk + 8 * jj + 2 * q4, s1 = s0 + 1;
          float* w = cb[jj];
          w[0] = s0 <= r0 ? w[0] * exp2f(at0 - as0) * ds0 : 0.f;
          w[1] = s1 <= r0 ? w[1] * exp2f(at0 - as1) * ds1 : 0.f;
          w[2] = s0 <= r1 ? w[2] * exp2f(at1 - as0) * ds0 : 0.f;
          w[3] = s1 <= r1 ? w[3] * exp2f(at1 - as1) * ds1 : 0.f;
        }
      }
      // the accumulators of the two 8-column tiles are W's A fragment
      uint32_t wh[4], wl[4];
      split2(cb[0][0], cb[0][1], wh[0], wl[0]);
      split2(cb[0][2], cb[0][3], wh[1], wl[1]);
      split2(cb[1][0], cb[1][1], wh[2], wl[2]);
      split2(cb[1][2], cb[1][3], wh[3], wl[3]);
#pragma unroll
      for (int pn = 0; pn < NX / 2; ++pn) {
        uint32_t bx[4];
        tc::ldsm_x4_trans(bx, xs + (16 * kk + lane % 16) * XP + p0 + 16 * pn +
                                  (lane / 16) * 8);
        tc::mma_bf16(yl[2 * pn], wl, bx[0], bx[1]);
        tc::mma_bf16(yl[2 * pn + 1], wl, bx[2], bx[3]);
        tc::mma_bf16(ya[2 * pn], wh, bx[0], bx[1]);
        tc::mma_bf16(ya[2 * pn + 1], wh, bx[2], bx[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int col = p0 + 8 * j + 2 * q4;
      *reinterpret_cast<uint32_t*>(ys + r0 * XP + col) =
          tc::pack_bf16(ya[j][0] + yl[j][0], ya[j][1] + yl[j][1]);
      *reinterpret_cast<uint32_t*>(ys + r1 * XP + col) =
          tc::pack_bf16(ya[j][2] + yl[j][2], ya[j][3] + yl[j][3]);
    }
    __syncthreads();  // every read of the stored state is done; y is whole
    // y to device memory, 16 bytes a thread and step, rows past S left out
    // (stores of the 4-byte fragments themselves took longer)
    for (int i = tid; i < n * (P / 8); i += NT) {
      const int t = i / (P / 8), c = 8 * (i % (P / 8));
      *reinterpret_cast<uint4*>(yg + (t0 + t) * xrow + c) =
          *reinterpret_cast<const uint4*>(ys + t * XP + c);
    }

    // 3. h <- exp2(acs_L) h + x^T (tail * B) in the accumulators, then
    //    stored as hi and lo for the next tile
    const float decay = exp2f(acs_last);
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[i][c] *= decay;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // rows s = 16 kk .. 16 kk + 15
      uint32_t xa[4];
      tc::ldsm_x4_trans(xa, xs + (16 * kk + lane % 8 + (lane / 16) * 8) * XP +
                                p0 + 16 * mt + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = jw + WM * i;
        if (j >= SN) break;
        const int o = (16 * kk + lane % 16) * NP + 8 * j;
        uint32_t bh[2], bl[2];
        tc::ldsm_x2_trans(bh, tb + o);
        tc::ldsm_x2_trans(bl, tb_lo + o);
        tc::mma_bf16(sacc[i], xa, bl[0], bl[1]);
        tc::mma_bf16(sacc[i], xa, bh[0], bh[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int j = jw + WM * i;
      if (j >= SN) break;
      const int o = (p0 + 16 * mt + g) * NP + 8 * j + 2 * q4;
      uint32_t hi, lo;
      split2(sacc[i][0], sacc[i][1], hi, lo);
      *reinterpret_cast<uint32_t*>(hs + o) = hi;
      *reinterpret_cast<uint32_t*>(hs_lo + o) = lo;
      split2(sacc[i][2], sacc[i][3], hi, lo);
      *reinterpret_cast<uint32_t*>(hs + o + 8 * NP) = hi;
      *reinterpret_cast<uint32_t*>(hs_lo + o + 8 * NP) = lo;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_with(K kernel, size_t smem, dim3 grid, int threads,
                        const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch_with(ssd_tc_kernel<P, N>, Tc<P, N>::BYTES, dim3(p.H, p.B),
                       Tc<P, N>::NT, p, stream);
  return launch_with(ssd_f32_kernel<P, N>, smem_bytes_f32<P, N>(),
                     dim3(p.H, p.B), NT32, p, stream);
}

template <int P>
cudaError_t dispatch_n(const Params& p, int N, int dtype,
                       cudaStream_t stream) {
  switch (N) {
    case 16: return launch<P, 16>(p, dtype, stream);
    case 32: return launch<P, 32>(p, dtype, stream);
    case 64: return launch<P, 64>(p, dtype, stream);
    case 128: return launch<P, 128>(p, dtype, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success).  The caller has
// checked shapes, dtypes and contiguity; dtype 0 is float32, 1 is bfloat16
// (of x, B, C and y; dt and A are float32).  The bf16 kernel copies 16-byte
// chunks, so x, B, C and y must be 16-byte aligned
// (cudaErrorMisalignedAddress otherwise).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, int B,
                            int S, int H, int P, int N, int dtype,
                            void* stream) {
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, y, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 &&
      !(aligned16(x) && aligned16(Bm) && aligned16(Cm) && aligned16(y)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  switch (P) {
    case 16: err = dispatch_n<16>(p, N, dtype, st); break;
    case 32: err = dispatch_n<32>(p, N, dtype, st); break;
    case 64: err = dispatch_n<64>(p, N, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
