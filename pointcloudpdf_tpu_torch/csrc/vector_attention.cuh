// Shared by the PT-v1 vector-attention kernels (forward and backward): the
// packed parameter buffer's layout.
#pragma once

#include "common.cuh"

namespace pcpdf {

// offsets into the packed parameter buffer (floats); the backward kernel
// writes the parameters' cotangents into a buffer of the same layout
struct AttnLayout {
  int p1w, p1b, ps, pt, p2w, p2b, s1, t1, w1t, b1, s2, t2, w2, b2, total;
};

__host__ __device__ constexpr AttnLayout attn_layout(int C, int G) {
  AttnLayout l{};
  l.p1w = 0;            // (3, 3) [in][out]
  l.p1b = 9;            // (3)
  l.ps = 12;            // (3)
  l.pt = 15;            // (3)
  l.p2w = 18;           // (3, C) [in][out]
  l.p2b = l.p2w + 3 * C;
  l.s1 = l.p2b + C;
  l.t1 = l.s1 + C;
  l.w1t = l.t1 + C;     // (G, C): W_w1 transposed
  l.b1 = l.w1t + G * C;
  l.s2 = l.b1 + G;
  l.t2 = l.s2 + G;
  l.w2 = l.t2 + G;      // (G, G) [in][out]
  l.b2 = l.w2 + G * G;
  l.total = l.b2 + G;
  return l;
}

}  // namespace pcpdf
