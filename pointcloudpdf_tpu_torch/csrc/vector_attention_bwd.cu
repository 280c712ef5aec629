// K4: PT-v1 vector attention, backward of the training forward.
//
// Replaces the TPU kernel _attn_bwd_kernel (called from
// _attention_core_bwd, pointcloudpdf_tpu/ops/pallas_attention.py).  The
// forward is vector_attention.cu with the affines (s, t) folded from the
// batch's masked statistics; it saves its inputs only.  Given dout
// (B, N, C), this kernel recomputes the chain per query and emits
//   d x_q  (B, N, C)  direct store, -sum_j dr
//   d x_k, d x_v      atomicAdd at the gathered row j into zeroed buffers
//                     (the TPU version returned a payload-shaped cotangent
//                     and left the scatter to XLA's gather transpose; with
//                     the gather inside the kernel the scatter is here too)
//   d params          the cotangents of the four (W, b) pairs and the six
//                     affine vectors, in the layout of the packed parameter
//                     buffer (attn_layout)
// Masked neighbour slots are skipped: they add nothing to any output.
// coord gets no cotangent (it is input data in every caller).
//
// Bound on the card: per neighbour it gathers a row of x_k and of x_v and
// scatters a row of d x_k and of d x_v (16*C bytes, the scatter as atomics
// that L2 resolves) against ~8*C*G multiply-adds of the weight MLP (two
// recomputes and the two transposed products): 2 operations per byte at
// C = 32, so bytes bound the wide early stages, and 32 per byte at C = 512,
// so operations bound the narrow late ones.
// Design: one warp per query, each lane owning channels lane + 32 t, as in
// the forward.  The softmax backward needs sum_j w_j * dw_j per group before
// any d logit, so the neighbours are swept twice: sweep 1 recomputes the
// chain and keeps each neighbour's logit and dw for the lane's groups
// (K <= 16 values, indexed at run time, so they live in local memory);
// sweep 2 recomputes the chain again and runs the backward.  The ReLU
// gates come from the recomputed chain, written with the forward kernel's
// expressions.  Parameter cotangents: for C <= 128 every lane keeps its
// share in registers over the whole launch; for C >= 256 (too many
// registers) each neighbour's contribution goes to a block-wide
// accumulator in shared memory with shared-memory atomics.  Either way a
// block reduces into shared memory and ends with ONE atomicAdd per element
// into the zeroed global buffer, rather than per-block partials summed
// outside: at C = 512 a partial is 160 KB per block, and the sum over a few
// hundred blocks is a fraction of the launch.  At C = 512 the weights and
// the accumulator do not both fit in shared memory (2 x 160 KB), so W_w1
// (128 KB) is read from device memory through L1/L2 there.
// Atomics make d x_k, d x_v and d params differ in the last bits from run
// to run.  Sums are in f32.

#include "vector_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxK = 16;

using Layout = pcpdf::AttnLayout;

#define PCPDF_ACC(reg, off, v)                 \
  do {                                         \
    if constexpr (kSmall) {                    \
      reg += (v);                              \
    } else {                                   \
      atomicAdd(&gacc[off], (v));              \
    }                                          \
  } while (0)

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_kernel(const float* __restrict__ xq, const float* __restrict__ xk,
                const float* __restrict__ xv, const float* __restrict__ coord,
                const int* __restrict__ idx, const uint8_t* __restrict__ nmask,
                const float* __restrict__ params,
                const float* __restrict__ dout, int B, int N, int K,
                float* __restrict__ dxq, float* __restrict__ dxk,
                float* __restrict__ dxv, float* __restrict__ dparams) {
  constexpr int G = C / 8;
  constexpr int CPL = C / 32;               // channels per lane
  constexpr int GPL = G > 32 ? G / 32 : 1;  // distinct groups per lane
  constexpr bool kSmall = C <= 128;         // register accumulators
  constexpr bool kW1Shared = C <= 256;      // W_w1 in shared memory
  constexpr Layout L = pcpdf::attn_layout(C, G);
  constexpr int kWeights = kW1Shared ? L.total : L.total - G * C;
  extern __shared__ float smem[];
  float* wlo = smem;                               // entries before w1t
  float* whi = kW1Shared ? smem : smem - G * C;    // entries from b1 on
  const float* w1t = kW1Shared ? smem + L.w1t : params + L.w1t;
  float* gacc = smem + kWeights;                   // (L.total) cotangents

  for (int i = threadIdx.x; i < L.total; i += blockDim.x) {
    if (i < L.w1t) {
      wlo[i] = params[i];
    } else if (i >= L.b1) {
      whi[i] = params[i];
    } else if (kW1Shared) {
      smem[i] = params[i];
    }
    gacc[i] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long M = (long long)B * N;

  // the lane's groups: G < 32 -> lane % G (lanes >= G hold copies);
  // G >= 32 -> lane + 32 u
  int gown[GPL];
#pragma unroll
  for (int u = 0; u < GPL; ++u) gown[u] = (lane + 32 * u) % G;

  // accumulators kept over the whole launch
  float acc_p1[18];  // d W_p1 [in j][out i] (9), d b_p1, d s_p, d t_p (3 each)
#pragma unroll
  for (int i = 0; i < 18; ++i) acc_p1[i] = 0.f;
  float acc_ch[kSmall ? 6 * CPL : 1];  // per t: d W_p2 rows 0-2, d b_p2, d s1, d t1
  float acc_w1[kSmall ? CPL * G : 1];  // [t][g]
  float acc_g[kSmall ? G + 4 : 1];     // d W_w2 column, d b2, d s2, d t2, d b1
  if constexpr (kSmall) {
#pragma unroll
    for (int i = 0; i < 6 * CPL; ++i) acc_ch[i] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL * G; ++i) acc_w1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < G + 4; ++i) acc_g[i] = 0.f;
  }

  for (long long m = (long long)blockIdx.x * kWarps + warp; m < M;
       m += (long long)gridDim.x * kWarps) {
    const int b = (int)(m / N);
    float qv[CPL], dO[CPL], dq[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      qv[t] = xq[m * C + lane + 32 * t];
      dO[t] = dout[m * C + lane + 32 * t];
      dq[t] = 0.f;
    }
    const float qx = coord[m * 3 + 0], qy = coord[m * 3 + 1],
                qz = coord[m * 3 + 2];

    // the chain of one neighbour, recomputed by both sweeps
    long long row;
    float prel[3], z1[3], pre1[3], h[3];
    float pr[CPL], rraw[CPL];
    float araw[G];  // (r W_w1 + b_w1), all groups, in every lane
    float logit[GPL];
    auto chain = [&](int kk) {
      row = (long long)b * N + idx[m * K + kk];
      prel[0] = coord[row * 3 + 0] - qx;
      prel[1] = coord[row * 3 + 1] - qy;
      prel[2] = coord[row * 3 + 2] - qz;
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        z1[o] = wlo[L.p1b + o] + prel[0] * wlo[L.p1w + 0 * 3 + o] +
                prel[1] * wlo[L.p1w + 1 * 3 + o] +
                prel[2] * wlo[L.p1w + 2 * 3 + o];
        pre1[o] = z1[o] * wlo[L.ps + o] + wlo[L.pt + o];
        h[o] = fmaxf(pre1[o], 0.f);
      }
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        pr[t] = wlo[L.p2b + c] + h[0] * wlo[L.p2w + c] +
                h[1] * wlo[L.p2w + C + c] + h[2] * wlo[L.p2w + 2 * C + c];
        rraw[t] = xk[row * C + c] - qv[t] + pr[t];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          const int c = lane + 32 * t;
          const float rr = fmaxf(rraw[t] * wlo[L.s1 + c] + wlo[L.t1 + c], 0.f);
          s += rr * w1t[g * C + c];
        }
        araw[g] = s;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          araw[g] += __shfl_xor_sync(0xffffffffu, araw[g], off);
        araw[g] += whi[L.b1 + g];
      }
#pragma unroll
      for (int u = 0; u < GPL; ++u) {
        float s = whi[L.b2 + gown[u]];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float h3 =
              fmaxf(araw[g] * whi[L.s2 + g] + whi[L.t2 + g], 0.f);
          s += h3 * whi[L.w2 + g * G + gown[u]];
        }
        logit[u] = s;
      }
    };

    // sweep 1: logits and dw = sum_{c in group} dout[c] * (x_v[c] + p_r[c])
    float lg[kMaxK * GPL], dwv[kMaxK * GPL];
    float mx[GPL], den[GPL], dot[GPL];
#pragma unroll
    for (int u = 0; u < GPL; ++u) mx[u] = -INFINITY;
    bool any = false;
    for (int kk = 0; kk < K; ++kk) {
      if (!nmask[m * K + kk]) continue;  // warp-uniform
      any = true;
      chain(kk);
#pragma unroll
      for (int u = 0; u < GPL; ++u) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < CPL; ++t)
          if (t % GPL == u)
            s += dO[t] * (xv[row * C + lane + 32 * t] + pr[t]);
        if constexpr (G < 32) {
#pragma unroll
          for (int off = G; off < 32; off <<= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        lg[kk * GPL + u] = logit[u];
        dwv[kk * GPL + u] = s;
        mx[u] = fmaxf(mx[u], logit[u]);
      }
    }
    if (any) {
#pragma unroll
      for (int u = 0; u < GPL; ++u) den[u] = dot[u] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        if (!nmask[m * K + kk]) continue;
#pragma unroll
        for (int u = 0; u < GPL; ++u) {
          const float e = expf(lg[kk * GPL + u] - mx[u]);
          den[u] += e;
          dot[u] += e * dwv[kk * GPL + u];
        }
      }
#pragma unroll
      for (int u = 0; u < GPL; ++u) dot[u] /= den[u];  // sum_j w_j dw_j

      // sweep 2: the backward of each neighbour
      for (int kk = 0; kk < K; ++kk) {
        if (!nmask[m * K + kk]) continue;
        chain(kk);
        float wgt[GPL], ds[GPL];
#pragma unroll
        for (int u = 0; u < GPL; ++u) {
          wgt[u] = expf(lg[kk * GPL + u] - mx[u]) / den[u];
          ds[u] = wgt[u] * (dwv[kk * GPL + u] - dot[u]);
        }
        float dpr[CPL];
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          dpr[t] = dO[t] * wgt[t % GPL];  // d (x_v + p_r)
          atomicAdd(&dxv[row * C + lane + 32 * t], dpr[t]);
        }

        // d W_w2[:, own], d b_w2[own]
#pragma unroll
        for (int u = 0; u < GPL; ++u) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float h3 =
                fmaxf(araw[g] * whi[L.s2 + g] + whi[L.t2 + g], 0.f);
            PCPDF_ACC(acc_g[g], L.w2 + g * G + gown[u], h3 * ds[u]);
          }
          PCPDF_ACC(acc_g[G], L.b2 + gown[u], ds[u]);
        }
        // d h3[own] = sum_g' ds[g'] W_w2[own][g'], ds gathered lane by lane
        float dh3[GPL], aown[GPL];
#pragma unroll
        for (int u = 0; u < GPL; ++u) dh3[u] = aown[u] = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float d = __shfl_sync(0xffffffffu, ds[g / 32], g % 32);
#pragma unroll
          for (int u = 0; u < GPL; ++u) {
            dh3[u] += d * whi[L.w2 + gown[u] * G + g];
            if (g == gown[u]) aown[u] = araw[g];
          }
        }
        float du[GPL];
#pragma unroll
        for (int u = 0; u < GPL; ++u) {
          const int g = gown[u];
          const float pre3 = aown[u] * whi[L.s2 + g] + whi[L.t2 + g];
          const float dpre3 = pre3 > 0.f ? dh3[u] : 0.f;
          du[u] = dpre3 * whi[L.s2 + g];
          PCPDF_ACC(acc_g[G + 1], L.s2 + g, dpre3 * aown[u]);
          PCPDF_ACC(acc_g[G + 2], L.t2 + g, dpre3);
          PCPDF_ACC(acc_g[G + 3], L.b1 + g, du[u]);
        }

        // d h2 = du W_w1^T and d W_w1 = h2^T du, group by group
        float dh2[CPL];
#pragma unroll
        for (int t = 0; t < CPL; ++t) dh2[t] = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float d = __shfl_sync(0xffffffffu, du[g / 32], g % 32);
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            const int c = lane + 32 * t;
            const float rr =
                fmaxf(rraw[t] * wlo[L.s1 + c] + wlo[L.t1 + c], 0.f);
            dh2[t] += d * w1t[g * C + c];
            PCPDF_ACC(acc_w1[t * G + g], L.w1t + g * C + c, rr * d);
          }
        }

        float dh1[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          const int c = lane + 32 * t;
          const float pre2 = rraw[t] * wlo[L.s1 + c] + wlo[L.t1 + c];
          const float dpre2 = pre2 > 0.f ? dh2[t] : 0.f;
          const float dr = dpre2 * wlo[L.s1 + c];
          PCPDF_ACC(acc_ch[6 * t + 4], L.s1 + c, dpre2 * rraw[t]);
          PCPDF_ACC(acc_ch[6 * t + 5], L.t1 + c, dpre2);
          atomicAdd(&dxk[row * C + c], dr);
          dq[t] -= dr;
          dpr[t] += dr;
          PCPDF_ACC(acc_ch[6 * t + 3], L.p2b + c, dpr[t]);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            PCPDF_ACC(acc_ch[6 * t + i], L.p2w + i * C + c, h[i] * dpr[t]);
            dh1[i] += dpr[t] * wlo[L.p2w + i * C + c];
          }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            dh1[i] += __shfl_xor_sync(0xffffffffu, dh1[i], off);
          const float dpre1 = pre1[i] > 0.f ? dh1[i] : 0.f;
          const float dz1 = dpre1 * wlo[L.ps + i];
          acc_p1[12 + i] += dpre1 * z1[i];
          acc_p1[15 + i] += dpre1;
          acc_p1[9 + i] += dz1;
#pragma unroll
          for (int j = 0; j < 3; ++j) acc_p1[j * 3 + i] += prel[j] * dz1;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < CPL; ++t) dxq[m * C + lane + 32 * t] = dq[t];
  }

  // registers -> the block's accumulator -> one atomicAdd per element
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) atomicAdd(&gacc[L.p1w + i], acc_p1[i]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      atomicAdd(&gacc[L.p1b + i], acc_p1[9 + i]);
      atomicAdd(&gacc[L.ps + i], acc_p1[12 + i]);
      atomicAdd(&gacc[L.pt + i], acc_p1[15 + i]);
    }
  }
  if constexpr (kSmall) {
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        atomicAdd(&gacc[L.p2w + i * C + c], acc_ch[6 * t + i]);
      atomicAdd(&gacc[L.p2b + c], acc_ch[6 * t + 3]);
      atomicAdd(&gacc[L.s1 + c], acc_ch[6 * t + 4]);
      atomicAdd(&gacc[L.t1 + c], acc_ch[6 * t + 5]);
#pragma unroll
      for (int g = 0; g < G; ++g)
        atomicAdd(&gacc[L.w1t + g * C + c], acc_w1[t * G + g]);
    }
    if (lane < G) {  // lanes >= G hold copies of lane % G
#pragma unroll
      for (int g = 0; g < G; ++g)
        atomicAdd(&gacc[L.w2 + g * G + lane], acc_g[g]);
      atomicAdd(&gacc[L.b2 + lane], acc_g[G]);
      atomicAdd(&gacc[L.s2 + lane], acc_g[G + 1]);
      atomicAdd(&gacc[L.t2 + lane], acc_g[G + 2]);
      atomicAdd(&gacc[L.b1 + lane], acc_g[G + 3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L.total; i += blockDim.x)
    atomicAdd(&dparams[i], gacc[i]);
}

template <int C>
int launch(const float* xq, const float* xk, const float* xv,
           const float* coord, const int* idx, const uint8_t* nmask,
           const float* params, const float* dout, int B, int N, int K,
           float* dxq, float* dxk, float* dxv, float* dparams,
           cudaStream_t stream) {
  constexpr int G = C / 8;
  constexpr Layout L = pcpdf::attn_layout(C, G);
  constexpr int kWeights = C <= 256 ? L.total : L.total - G * C;
  const size_t smem = (size_t)(kWeights + L.total) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, attn_bwd_kernel<C>, kWarps * 32, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // persistent blocks: each ends with L.total atomics, so no more blocks
  // than the card runs at once
  const long long M = (long long)B * N;
  const long long blocks = (M + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(blocks < resident ? blocks : resident);
  attn_bwd_kernel<C><<<grid, kWarps * 32, smem, stream>>>(
      xq, xk, xv, coord, idx, nmask, params, dout, B, N, K, dxq, dxk, dxv,
      dparams);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs as pcpdf_vector_attention, plus dout (B, N, C) f32.  Outputs:
// dxq (B, N, C) written; dxk, dxv (B, N, C) and dparams (attn_layout
// floats) accumulated into, so the caller zeroes them.  share = 8,
// C in {32, 64, 128, 256, 512}, K <= 16.
extern "C" int pcpdf_vector_attention_bwd(
    const void* xq, const void* xk, const void* xv, const void* coord,
    const void* idx, const void* nmask, const void* params, const void* dout,
    int B, int N, int C, int K, void* dxq, void* dxk, void* dxv,
    void* dparams, void* stream) {
  if ((long long)B * N == 0) return 0;
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  auto q = static_cast<const float*>(xq);
  auto k = static_cast<const float*>(xk);
  auto v = static_cast<const float*>(xv);
  auto c = static_cast<const float*>(coord);
  auto i = static_cast<const int*>(idx);
  auto nm = static_cast<const uint8_t*>(nmask);
  auto p = static_cast<const float*>(params);
  auto d = static_cast<const float*>(dout);
  auto dq = static_cast<float*>(dxq);
  auto dk = static_cast<float*>(dxk);
  auto dv = static_cast<float*>(dxv);
  auto dp = static_cast<float*>(dparams);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<32>(q, k, v, c, i, nm, p, d, B, N, K, dq, dk, dv, dp, s);
    case 64: return launch<64>(q, k, v, c, i, nm, p, d, B, N, K, dq, dk, dv, dp, s);
    case 128: return launch<128>(q, k, v, c, i, nm, p, d, B, N, K, dq, dk, dv, dp, s);
    case 256: return launch<256>(q, k, v, c, i, nm, p, d, B, N, K, dq, dk, dv, dp, s);
    case 512: return launch<512>(q, k, v, c, i, nm, p, d, B, N, K, dq, dk, dv, dp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
