// Inline-PTX building blocks of the tensor-core kernels (sm_80 and later,
// built here for sm_90a): 16- and 4-byte cp.async copies into shared memory,
// ldmatrix loads of 8x8 bf16 blocks, and the warp-level bf16 product
// mma.sync.m16n8k16 with fp32 accumulators.
//
// Fragment layout of m16n8k16 (lane = 4 * g + q, g = lane / 4, q = lane % 4):
//   A (16x16, row-major):  a0 (g, 2q..2q+1)  a1 (g+8, 2q..)  a2 (g, 8+2q..)
//                          a3 (g+8, 8+2q..)
//   B (16x8, k x n):       b0 (k 2q..2q+1, n g)  b1 (k 8+2q.., n g)
//   C/D (16x8, fp32):      c0, c1 (g, 2q..2q+1)  c2, c3 (g+8, 2q..2q+1)
// So the C fragments of two neighbouring n-tiles, packed to bf16 pairs, are
// the A fragment of a product over those 16 columns: P never leaves the
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with pred false the 16 bytes are zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared (through L1), zero-filled when pred is false:
// for strided scalars such as one head's dt.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 blocks; lanes 8i..8i+7 give the row addresses of block i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Two blocks; lanes 0..15 give the row addresses (16..31 are ignored).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16; lo in the low half, as the fragments want.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi): together about
// 16 mantissa bits.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// The accumulators of two neighbouring 8-column tiles (a 16 x 16 block) as
// the split A fragment of a product over those 16 columns.
__device__ __forceinline__ void frag_split(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// Warp-level products of one 16-row strip, bf16 in shared memory, fp32
// accumulators acc[j] for the 8-column tiles j < 2 NP of the output.
// A is 16 x 16 KT row-major at a (leading dimension lda elements).
// mma_nt: B is given as its transpose, (16 NP) x (16 KT) row-major at b:
//   acc += A . B^T.
template <int KT, int NP>
__device__ __forceinline__ void mma_nt(float (&acc)[2 * NP][4],
                                       const __nv_bfloat16* a, int lda,
                                       const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + 16 * kc + (lane / 16) * 8);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (16 * pn + lane % 8 + (lane / 16) * 8) * ldb +
                      16 * kc + ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * pn], af, bf[0], bf[1]);
      mma_bf16(acc[2 * pn + 1], af, bf[2], bf[3]);
    }
  }
}

// mma_nn: B is (16 KT) x (16 NP) row-major at b: acc += A . B.
template <int KT, int NP>
__device__ __forceinline__ void mma_nn(float (&acc)[2 * NP][4],
                                       const __nv_bfloat16* a, int lda,
                                       const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + 16 * kc + (lane / 16) * 8);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      uint32_t bx[4];
      ldsm_x4_trans(bx, b + (16 * kc + lane % 16) * ldb + 16 * pn +
                            (lane / 16) * 8);
      mma_bf16(acc[2 * pn], af, bx[0], bx[1]);
      mma_bf16(acc[2 * pn + 1], af, bx[2], bx[3]);
    }
  }
}

// The split forms: one operand given as hi and lo, the other loaded once
// for both products (acc += A . B_lo + A . B_hi, or A_lo . B + A_hi . B).
// mma_frag_nn: A from registers (a 16 x 16 fragment from frag_split) times
// rows 0 .. 15 of B, (16 NP) columns row-major at b.
template <int KT, int NP>
__device__ __forceinline__ void mma_nt2(float (&acc)[2 * NP][4],
                                        const __nv_bfloat16* a, int lda,
                                        const __nv_bfloat16* bhi,
                                        const __nv_bfloat16* blo, int ldb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + 16 * kc + (lane / 16) * 8);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      const int o = (16 * pn + lane % 8 + (lane / 16) * 8) * ldb + 16 * kc +
                    ((lane / 8) % 2) * 8;
      uint32_t bh[4], bl[4];
      ldsm_x4(bh, bhi + o);
      ldsm_x4(bl, blo + o);
      mma_bf16(acc[2 * pn], af, bl[0], bl[1]);
      mma_bf16(acc[2 * pn + 1], af, bl[2], bl[3]);
      mma_bf16(acc[2 * pn], af, bh[0], bh[1]);
      mma_bf16(acc[2 * pn + 1], af, bh[2], bh[3]);
    }
  }
}

template <int KT, int NP>
__device__ __forceinline__ void mma_nn2(float (&acc)[2 * NP][4],
                                        const __nv_bfloat16* a, int lda,
                                        const __nv_bfloat16* bhi,
                                        const __nv_bfloat16* blo, int ldb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + 16 * kc + (lane / 16) * 8);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      const int o = (16 * kc + lane % 16) * ldb + 16 * pn + (lane / 16) * 8;
      uint32_t bh[4], bl[4];
      ldsm_x4_trans(bh, bhi + o);
      ldsm_x4_trans(bl, blo + o);
      mma_bf16(acc[2 * pn], af, bl[0], bl[1]);
      mma_bf16(acc[2 * pn + 1], af, bl[2], bl[3]);
      mma_bf16(acc[2 * pn], af, bh[0], bh[1]);
      mma_bf16(acc[2 * pn + 1], af, bh[2], bh[3]);
    }
  }
}

template <int NP>
__device__ __forceinline__ void mma_frag_nn(float (&acc)[2 * NP][4],
                                             const uint32_t (&ahi)[4],
                                             const uint32_t (&alo)[4],
                                             const __nv_bfloat16* b,
                                             int ldb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int pn = 0; pn < NP; ++pn) {
    uint32_t bx[4];
    ldsm_x4_trans(bx, b + (lane % 16) * ldb + 16 * pn + (lane / 16) * 8);
    mma_bf16(acc[2 * pn], alo, bx[0], bx[1]);
    mma_bf16(acc[2 * pn + 1], alo, bx[2], bx[3]);
    mma_bf16(acc[2 * pn], ahi, bx[0], bx[1]);
    mma_bf16(acc[2 * pn + 1], ahi, bx[2], bx[3]);
  }
}

// mma_tn: A given as its transpose, (16 KT) x 16 row-major at at (the
// strip's 16 columns of it), B (16 KT) x (8 NT) row-major at b:
//   acc += A . B, A[m][k] = at[k][m].
template <int KT, int NT>
__device__ __forceinline__ void mma_tn(float (&acc)[NT][4],
                                       const __nv_bfloat16* at, int ldt,
                                       const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t af[4];
    ldsm_x4_trans(af, at + (16 * kc + lane % 8 + (lane / 16) * 8) * ldt +
                          ((lane / 8) % 2) * 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bf[2];
      ldsm_x2_trans(bf, b + (16 * kc + lane % 16) * ldb + 8 * j);
      mma_bf16(acc[j], af, bf[0], bf[1]);
    }
  }
}

}  // namespace tc
