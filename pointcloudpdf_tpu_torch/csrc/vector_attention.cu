// K3: PT-v1 vector attention, forward (inference, and the training
// forward of K4 with batch-statistic affines).
//
// Replaces the TPU kernel fused_vector_attention
// (pointcloudpdf_tpu/ops/pallas_attention.py, _attn_kernel).  Per query
// point, over its K neighbours j (nmask false -> probability 0):
//   p_rel = coord[j] - coord_q
//   p_r   = relu((p_rel W_p1 + b_p1) * s_p + t_p) W_p2 + b_p2         (C)
//   r     = relu((x_k[j] - x_q + p_r) * s_w1 + t_w1)                   (C)
//   a     = relu((r W_w1 + b_w1) * s_w2 + t_w2)                        (G)
//   logit = a W_w2 + b_w2                                              (G)
//   out[c] = sum_j softmax_j(logit)[c % G] * (x_v[j][c] + p_r[c])
// with G = C / share.  The BatchNorm affines (s, t) arrive folded: from the
// running statistics in eval, from the batch's masked statistics in
// training (vector_attention_bwd.cu is the backward).
//
// Bound on the card: bytes of the neighbour gather.  Each query reads K
// rows of x_k and x_v (8*K*C bytes) and writes C floats; the unfused
// PyTorch version also writes and re-reads some ten (B, N, K, C)
// intermediates.  Design: one warp per query, each lane owning channels
// lane + 32 t; the k/v/coord rows are gathered by index inside the kernel
// (no gathered payload in device memory), every intermediate stays in
// registers, the softmax over K runs online, and all MLP weights sit in
// shared memory for the block (W_w1 transposed, so a warp's reads are
// consecutive).  Sums are in f32.

#include "vector_attention.cuh"

namespace {

constexpr int kWarps = 8;

using Layout = pcpdf::AttnLayout;
__host__ __device__ constexpr Layout layout(int C, int G) {
  return pcpdf::attn_layout(C, G);
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
attn_kernel(const float* __restrict__ xq, const float* __restrict__ xk,
            const float* __restrict__ xv, const float* __restrict__ coord,
            const int* __restrict__ idx, const uint8_t* __restrict__ nmask,
            const float* __restrict__ params, int B, int N, int K,
            float* __restrict__ out) {
  constexpr int G = C / 8;
  constexpr int CPL = C / 32;            // channels per lane
  constexpr int GPL = G > 32 ? G / 32 : 1;  // distinct groups per lane
  constexpr Layout L = layout(C, G);
  extern __shared__ float w[];

  for (int i = threadIdx.x; i < L.total; i += blockDim.x) w[i] = params[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long M = (long long)B * N;
  for (long long m = (long long)blockIdx.x * kWarps + warp; m < M;
       m += (long long)gridDim.x * kWarps) {
    const int b = (int)(m / N);
    float qv[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) qv[t] = xq[m * C + lane + 32 * t];
    const float qx = coord[m * 3 + 0], qy = coord[m * 3 + 1],
                qz = coord[m * 3 + 2];

    float acc[CPL];
    float run_max[GPL], run_sum[GPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[t] = 0.f;
#pragma unroll
    for (int u = 0; u < GPL; ++u) {
      run_max[u] = -INFINITY;
      run_sum[u] = 0.f;
    }

    for (int kk = 0; kk < K; ++kk) {
      if (!nmask[m * K + kk]) continue;  // warp-uniform
      const long long row = (long long)b * N + idx[m * K + kk];

      // positional MLP, layer 1 (3 -> 3), computed by every lane
      const float px = coord[row * 3 + 0] - qx;
      const float py = coord[row * 3 + 1] - qy;
      const float pz = coord[row * 3 + 2] - qz;
      float h[3];
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        float v = w[L.p1b + o] + px * w[L.p1w + 0 * 3 + o] +
                  py * w[L.p1w + 1 * 3 + o] + pz * w[L.p1w + 2 * 3 + o];
        h[o] = fmaxf(v * w[L.ps + o] + w[L.pt + o], 0.f);
      }

      // layer 2 (3 -> C) and the relation, on this lane's channels
      float pr[CPL], rr[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        pr[t] = w[L.p2b + c] + h[0] * w[L.p2w + c] + h[1] * w[L.p2w + C + c] +
                h[2] * w[L.p2w + 2 * C + c];
        const float r = xk[row * C + c] - qv[t] + pr[t];
        rr[t] = fmaxf(r * w[L.s1 + c] + w[L.t1 + c], 0.f);
      }

      // weight MLP, layer 1 (C -> G): lane partials, then a butterfly
      // all-reduce so every lane holds all G sums
      float a[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < CPL; ++t) s += rr[t] * w[L.w1t + g * C + lane + 32 * t];
        a[g] = s;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a[g] += __shfl_xor_sync(0xffffffffu, a[g], off);
        a[g] = fmaxf((a[g] + w[L.b1 + g]) * w[L.s2 + g] + w[L.t2 + g], 0.f);
      }

      // layer 2 (G -> G), only for this lane's groups; online softmax
#pragma unroll
      for (int u = 0; u < GPL; ++u) {
        const int gu = (lane + 32 * u) % G;
        float logit = w[L.b2 + gu];
#pragma unroll
        for (int g = 0; g < G; ++g) logit += a[g] * w[L.w2 + g * G + gu];
        const float new_max = fmaxf(run_max[u], logit);
        const float scale = expf(run_max[u] - new_max);
        const float e = expf(logit - new_max);
        run_sum[u] = run_sum[u] * scale + e;
        run_max[u] = new_max;
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          if (t % GPL == u) {
            const int c = lane + 32 * t;
            acc[t] = acc[t] * scale + e * (xv[row * C + c] + pr[t]);
          }
        }
      }
    }

#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const float s = run_sum[t % GPL];
      out[m * C + lane + 32 * t] = s > 0.f ? acc[t] / s : 0.f;
    }
  }
}

template <int C>
int launch(const float* xq, const float* xk, const float* xv,
           const float* coord, const int* idx, const uint8_t* nmask,
           const float* params, int B, int N, int K, float* out,
           cudaStream_t stream) {
  constexpr Layout L = layout(C, C / 8);
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * N;
  const long long blocks = (M + kWarps - 1) / kWarps;
  const int grid = (int)(blocks < 8192 ? blocks : 8192);
  attn_kernel<C><<<grid, kWarps * 32, smem, stream>>>(
      xq, xk, xv, coord, idx, nmask, params, B, N, K, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x_q/x_k/x_v (B, N, C) f32, coord (B, N, 3) f32, idx (B, N, K) i32,
// nmask (B, N, K) u8, params packed as layout(C, C/8) -> out (B, N, C).
// share = 8, C in {32, 64, 128, 256, 512}.
extern "C" int pcpdf_vector_attention(const void* xq, const void* xk,
                                      const void* xv, const void* coord,
                                      const void* idx, const void* nmask,
                                      const void* params, int B, int N, int C,
                                      int K, void* out, void* stream) {
  if ((long long)B * N == 0) return 0;
  auto q = static_cast<const float*>(xq);
  auto k = static_cast<const float*>(xk);
  auto v = static_cast<const float*>(xv);
  auto c = static_cast<const float*>(coord);
  auto i = static_cast<const int*>(idx);
  auto nm = static_cast<const uint8_t*>(nmask);
  auto p = static_cast<const float*>(params);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<32>(q, k, v, c, i, nm, p, B, N, K, o, s);
    case 64: return launch<64>(q, k, v, c, i, nm, p, B, N, K, o, s);
    case 128: return launch<128>(q, k, v, c, i, nm, p, B, N, K, o, s);
    case 256: return launch<256>(q, k, v, c, i, nm, p, B, N, K, o, s);
    case 512: return launch<512>(q, k, v, c, i, nm, p, B, N, K, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// floats in the packed parameter buffer for width C (share 8)
extern "C" int pcpdf_vector_attention_params(int C) {
  return layout(C, C / 8).total;
}
