// K7: PT-v2 grouped vector attention, inference forward.
//
// Replaces the TPU kernel fused_grouped_vector_attention
// (pointcloudpdf_tpu/ops/pallas_gva.py, _gva_kernel).  Per query i, over its
// S neighbour slots j (nmask false -> probability 0), p = coord[j] - coord_i:
//   pem   = relu((p W_m1 + b_m1) * s_m + t_m) W_m2 + b_m2        (C, if on)
//   peb   = relu((p W_b1 + b_b1) * s_b + t_b) W_b2 + b_b2        (C, if on)
//   rel   = (k[j] - q_i) * pem + peb,   v_eff = v[j] + peb
//   a     = relu((rel W_e1 + b_e1) * s_e + t_e)                   (G)
//   logit = a W_e2 + b_e2                                         (G)
//   out[c] = sum_j softmax_j(logit)[c / 8] * v_eff[c]
// with 8 channels a group (G = C / 8) and the BatchNorm affines (s, t)
// folded from the running statistics.  A query with no valid slot comes
// out 0.
//
// Bound on the card: operations.  Each positional encoding that is on costs
// a C x C product for every (query, neighbour) pair, 2 C^2 flop, against
// ~16 C bytes a query; at C = 384 that is 295k flop a pair.  Design: one
// warp per query, lane l owning channels l + 32 r; a warp takes T neighbour
// slots at a time, writes their hidden layer (3 -> C, ReLU) into its own
// staging rows of shared memory and runs the C x C product over the T pairs
// at once, so each weight it reads serves T pairs (lane l reads column
// l + 32 r of a row, neighbouring lanes neighbouring words; the hidden values
// are broadcast reads).  The weights sit in shared memory for the block
// where they fit (C x C in f32: 9 KB at C = 48, 147 KB at 192) and are read
// through L1/L2 where they do not (590 KB at C = 384): that case is slow.
// The weight encoding reduces C -> G over the warp with a butterfly; the
// softmax over S runs online, so a lane keeps three floats a channel.  The
// k/v/coord rows are gathered by index inside the kernel (no payload slab,
// no bf16), and every sum is in f32.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

// offsets into the packed small-parameter buffer (floats)
struct GvaLayout {
  int m1w, m1b, ms, mt, m2b, b1w, b1b, bs, bt, b2b, e1b, es, et, e2w, e2b,
      head, e1t, total;
};

__host__ __device__ constexpr GvaLayout gva_layout(int C, int G) {
  GvaLayout l{};
  l.m1w = 0;             // (3, C) [in][out]
  l.m1b = 3 * C;
  l.ms = 4 * C;
  l.mt = 5 * C;
  l.m2b = 6 * C;
  l.b1w = 7 * C;         // (3, C) [in][out]
  l.b1b = 10 * C;
  l.bs = 11 * C;
  l.bt = 12 * C;
  l.b2b = 13 * C;
  l.e1b = 14 * C;
  l.es = l.e1b + G;
  l.et = l.es + G;
  l.e2w = l.et + G;      // (G, G) [in][out]
  l.e2b = l.e2w + G * G;
  l.head = l.e2b + G;
  l.e1t = l.head;        // (G, C): W_e1 transposed
  l.total = l.e1t + G * C;
  return l;
}

// neighbour slots a warp takes at once (its accumulators: T x ceil(C / 32))
template <int C>
__host__ __device__ constexpr int chunk() {
  return C <= 96 ? 8 : C <= 384 ? 4 : 2;
}

// One positional encoding over a chunk of T pairs: the hidden layer of this
// lane's channels into the warp's staging rows, then y = hidden W2 + b2 on
// this lane's channels.  w2 is (C, C) [in][out], in shared or device memory.
template <int C>
__device__ __forceinline__ void pe_chunk(const float* w1, const float* b1,
                                         const float* s1, const float* t1,
                                         const float* w2, const float* b2,
                                         float (&rp)[chunk<C>()][3],
                                         float* hid, int lane,
                                         float (&y)[chunk<C>()][(C + 31) / 32]) {
  constexpr int T = chunk<C>(), R = (C + 31) / 32;
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (c < C) {
        const float h = b1[c] + rp[t][0] * w1[c] + rp[t][1] * w1[C + c] +
                        rp[t][2] * w1[2 * C + c];
        hid[t * C + c] = fmaxf(h * s1[c] + t1[c], 0.f);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      y[t][r] = c < C ? b2[c] : 0.f;
    }
  }
#pragma unroll 2
  for (int i = 0; i < C; ++i) {
    float w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      w[r] = c < C ? w2[i * C + c] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float h = hid[t * C + i];
#pragma unroll
      for (int r = 0; r < R; ++r) y[t][r] = fmaf(h, w[r], y[t][r]);
    }
  }
  __syncwarp();  // the staging rows are written again by the next chunk
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
gva_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ coord,
           const int* __restrict__ idx, const uint8_t* __restrict__ nmask,
           const float* __restrict__ params, const float* __restrict__ pm2,
           const float* __restrict__ pb2, int pe_mul, int pe_bias,
           int e1t_resident, int w2_resident, int B, int N, int S,
           float* __restrict__ out) {
  constexpr int G = C / 8, R = (C + 31) / 32, T = chunk<C>();
  constexpr GvaLayout L = gva_layout(C, G);
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // block-resident parameters: the small ones always, W_e1 and the C x C
  // matrices where they fit; then each warp's staging rows
  for (int i = threadIdx.x; i < L.head; i += blockDim.x) smem[i] = params[i];
  int at = L.head;
  const float* e1t = params + L.e1t;
  if (e1t_resident) {
    for (int i = threadIdx.x; i < G * C; i += blockDim.x)
      smem[at + i] = params[L.e1t + i];
    e1t = smem + at;
    at += G * C;
  }
  const float* wm = pm2;
  const float* wb = pb2;
  if (w2_resident) {
    if (pe_mul) {
      for (int i = threadIdx.x; i < C * C; i += blockDim.x) smem[at + i] = pm2[i];
      wm = smem + at;
      at += C * C;
    }
    if (pe_bias) {
      for (int i = threadIdx.x; i < C * C; i += blockDim.x) smem[at + i] = pb2[i];
      wb = smem + at;
      at += C * C;
    }
  }
  float* hid = smem + at + warp * (1 + pe_mul) * T * C;
  float* pem = hid + T * C;  // the multiplier of a chunk, with pe_mul
  const float* p = smem;
  __syncthreads();

  const long long M = (long long)B * N;
  for (long long m = (long long)blockIdx.x * kWarps + warp; m < M;
       m += (long long)gridDim.x * kWarps) {
    const long long base = (m / N) * N;
    float qv[R], run_max[R], run_sum[R], acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      qv[r] = c < C ? q[m * C + c] : 0.f;
      run_max[r] = -INFINITY;
      run_sum[r] = 0.f;
      acc[r] = 0.f;
    }
    const float cq[3] = {coord[m * 3 + 0], coord[m * 3 + 1], coord[m * 3 + 2]};

    for (int s0 = 0; s0 < S; s0 += T) {
      long long row[T];
      bool ok[T];
      float rp[T][3];
      bool any = false;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int s = s0 + t;
        ok[t] = s < S && nmask[m * S + s];
        any |= ok[t];
        row[t] = base + (ok[t] ? idx[m * S + s] : 0);
#pragma unroll
        for (int a = 0; a < 3; ++a) rp[t][a] = coord[row[t] * 3 + a] - cq[a];
      }
      if (!any) continue;  // warp-uniform

      float pe[T][R];
      if (pe_mul) {
        pe_chunk<C>(p + L.m1w, p + L.m1b, p + L.ms, p + L.mt, wm, p + L.m2b, rp,
                    hid, lane, pe);
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (lane + 32 * r < C) pem[t * C + lane + 32 * r] = pe[t][r];
      }
      if (pe_bias)
        pe_chunk<C>(p + L.b1w, p + L.b1b, p + L.bs, p + L.bt, wb, p + L.b2b, rp,
                    hid, lane, pe);

#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (!ok[t]) continue;  // warp-uniform
        float rel[R], ve[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int c = lane + 32 * r;
          rel[r] = ve[r] = 0.f;
          if (c < C) {
            float x = k[row[t] * C + c] - qv[r];
            if (pe_mul) x *= pem[t * C + c];
            const float b = pe_bias ? pe[t][r] : 0.f;
            rel[r] = x + b;
            ve[r] = v[row[t] * C + c] + b;
          }
        }
        // weight encoding, layer 1 (C -> G): lane partials, then a
        // butterfly all-reduce so that every lane holds all G sums
        float a[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (lane + 32 * r < C) s += rel[r] * e1t[g * C + lane + 32 * r];
          a[g] = s;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            a[g] += __shfl_xor_sync(0xffffffffu, a[g], off);
          a[g] = fmaxf((a[g] + p[L.e1b + g]) * p[L.es + g] + p[L.et + g], 0.f);
        }
        // layer 2 (G -> G) for the group of each of this lane's channels,
        // then the online softmax over the slots
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int c = lane + 32 * r;
          if (c < C) {
            const int g = c / 8;
            float logit = p[L.e2b + g];
#pragma unroll
            for (int h = 0; h < G; ++h) logit += a[h] * p[L.e2w + h * G + g];
            const float new_max = fmaxf(run_max[r], logit);
            const float keep = expf(run_max[r] - new_max);
            const float e = expf(logit - new_max);
            run_sum[r] = run_sum[r] * keep + e;
            acc[r] = acc[r] * keep + e * ve[r];
            run_max[r] = new_max;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (c < C) out[m * C + c] = run_sum[r] > 0.f ? acc[r] / run_sum[r] : 0.f;
    }
  }
}

template <int C>
int launch(const float* q, const float* k, const float* v, const float* coord,
           const int* idx, const uint8_t* nmask, const float* params,
           const float* pm2, const float* pb2, int pe_mul, int pe_bias, int B,
           int N, int S, float* out, cudaStream_t stream) {
  constexpr int G = C / 8, T = chunk<C>();
  constexpr GvaLayout L = gva_layout(C, G);
  int dev = 0, budget = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // what lives in shared memory: the small parameters and the staging rows
  // always; W_e1 and the C x C matrices where they fit beside them
  const size_t f = sizeof(float);
  const size_t head = (size_t)L.head * f, e1t = (size_t)G * C * f;
  const size_t w2 = (size_t)(pe_mul + pe_bias) * C * C * f;
  const size_t stage = (size_t)kWarps * (1 + pe_mul) * T * C * f;
  const int w2_resident = head + e1t + w2 + stage <= (size_t)budget;
  const int e1t_resident =
      head + e1t + (w2_resident ? w2 : 0) + stage <= (size_t)budget;
  const size_t smem =
      head + (e1t_resident ? e1t : 0) + (w2_resident ? w2 : 0) + stage;
  if (smem > (size_t)budget) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gva_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gva_kernel<C>,
                                                        kWarps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // a persistent grid: each block loads the weights once
  const long long M = (long long)B * N;
  const long long blocks = (M + kWarps - 1) / kWarps;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(blocks < cap ? blocks : cap);
  gva_kernel<C><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, coord, idx, nmask, params, pm2, pb2, pe_mul, pe_bias,
      e1t_resident, w2_resident, B, N, S, out);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v (B, N, C) f32, coord (B, N, 3) f32, idx (B, N, S) i32 rows of the
// same sample, nmask (B, N, S) u8, params packed as gva_layout(C, C / 8),
// pm2/pb2 (C, C) [in][out] (read only for a branch that is on) -> out
// (B, N, C) f32.  8 channels a group, C in {48, 96, 192, 384, 512}.
extern "C" int pcpdf_gva(const void* q, const void* k, const void* v,
                         const void* coord, const void* idx, const void* nmask,
                         const void* params, const void* pm2, const void* pb2,
                         int pe_mul, int pe_bias, int B, int N, int C, int S,
                         void* out, void* stream) {
  if ((long long)B * N == 0) return 0;
  if (S < 0) return (int)cudaErrorInvalidValue;
#define PCPDF_GVA_LAUNCH(W)                                                   \
  case W:                                                                     \
    return launch<W>(                                                         \
        static_cast<const float*>(q), static_cast<const float*>(k),          \
        static_cast<const float*>(v), static_cast<const float*>(coord),      \
        static_cast<const int*>(idx), static_cast<const uint8_t*>(nmask),    \
        static_cast<const float*>(params), static_cast<const float*>(pm2),   \
        static_cast<const float*>(pb2), pe_mul != 0, pe_bias != 0, B, N, S,  \
        static_cast<float*>(out), static_cast<cudaStream_t>(stream));
  switch (C) {
    PCPDF_GVA_LAUNCH(48)
    PCPDF_GVA_LAUNCH(96)
    PCPDF_GVA_LAUNCH(192)
    PCPDF_GVA_LAUNCH(384)
    PCPDF_GVA_LAUNCH(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PCPDF_GVA_LAUNCH
}

// floats in the packed small-parameter buffer for width C (8 channels a
// group)
extern "C" int pcpdf_gva_params(int C) {
  return C % 8 != 0 ? -1 : gva_layout(C, C / 8).total;
}
