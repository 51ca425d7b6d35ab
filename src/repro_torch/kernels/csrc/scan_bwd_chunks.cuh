// Shared by the scans' bf16 backward kernels (csrc/wkv6_scan_bwd.cu,
// csrc/ssd_scan_bwd.cu): step (b) of their design, the scan of the chunk
// summaries over the chunks, and a 4-lane sum.
#pragma once

#include <cuda_runtime.h>

namespace {

// the sum over the 4 lanes of a quad (an mma fragment row's columns)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// (b) The scan over chunks, in place.  The summaries lie shifted: slot
// c + 1 of hst holds G_c and slot c - 1 of gst holds Q_c, so that after
//   h = h dec_{c-1} + hst[c], hst[c] <- h      (c = 1 .. nc - 1, h = 0)
//   g = Q + dec_{c+1} g,     gst[c] <- g      (c = nc - 2 .. 0, g = 0)
// hst[c] is the state entering chunk c and gst[c] the gradient leaving it
// (slot 0 of hst and slot nc - 1 of gst are never read: those are 0).  At
// two chunks the slots already hold the answer and this kernel is not
// launched.  A thread an element e of one (b, h)'s E-element state; its
// decay is dec[(bh nc + c) dr + e / (E / dr)] (dr = 1: one a chunk; dr =
// D: one a state row).  Loads go 8 chunks ahead of the recurrence.
__global__ void scan_chunks_kernel(float* hst, float* gst, const float* dec,
                                   int nc, int E, int dr) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long bh = blockIdx.y;
  float* hp = hst + bh * nc * E + e;
  float* gp = gst + bh * nc * E + e;
  const float* dp = dec + bh * nc * dr + e / (E / dr);
  float h = 0.f, g = 0.f;
  for (int c0 = 1; c0 < nc; c0 += 8) {
    float v[8], d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool in = c0 + i < nc;
      v[i] = in ? hp[(long long)(c0 + i) * E] : 0.f;
      d[i] = in ? dp[(long long)(c0 + i - 1) * dr] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i >= nc) break;
      h = fmaf(h, d[i], v[i]);
      hp[(long long)(c0 + i) * E] = h;
    }
  }
  for (int c1 = nc - 2; c1 >= 0; c1 -= 8) {
    float v[8], d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool in = c1 - i >= 0;
      v[i] = in ? gp[(long long)(c1 - i) * E] : 0.f;
      d[i] = in ? dp[(long long)(c1 - i + 1) * dr] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c1 - i < 0) break;
      g = fmaf(d[i], g, v[i]);
      gp[(long long)(c1 - i) * E] = g;
    }
  }
}

}  // namespace
