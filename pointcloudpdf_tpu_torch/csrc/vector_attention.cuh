// Shared by the PT-v1 vector-attention kernels, forward
// (vector_attention.cu) and backward (vector_attention_bwd.cu): the packed
// parameter buffer's layout and the chain's elementwise steps up to the
// relation r.  Both kernels form every ReLU input with these expressions
// and U = h2 W_w1 with the same k-steps and split-TF32 rounding, so the
// backward's recompute opens the same ReLU gates as the forward.
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

// The positional MLP's first layer of one pair, from p_rel = coord[j] -
// coord[q]: f[o] = p_rel, f[3 + o] = z1, f[6 + o] = pre1, f[9 + o] = h
__device__ __forceinline__ void attn_pos_hidden(const float* params,
                                                const AttnLayout& L,
                                                const float (&prel)[3],
                                                float* f) {
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float z1 = params[L.p1b + o] + prel[0] * params[L.p1w + o] +
                     prel[1] * params[L.p1w + 3 + o] +
                     prel[2] * params[L.p1w + 6 + o];
    const float pre1 = z1 * params[L.ps + o] + params[L.pt + o];
    f[o] = prel[o];
    f[3 + o] = z1;
    f[6 + o] = pre1;
    f[9 + o] = fmaxf(pre1, 0.f);
  }
}

// p_r of one channel from the pair's hidden values h and the channel's
// column of W_p2 (w) and b_p2 (b)
__device__ __forceinline__ float attn_pr(float b, float h0, float h1, float h2,
                                         float w0, float w1, float w2) {
  return b + h0 * w0 + h1 * w1 + h2 * w2;
}

}  // namespace pcpdf
