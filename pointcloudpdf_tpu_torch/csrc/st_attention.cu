// K5: Stratified-Transformer window attention with contextual relative
// position encoding (cRPE) over a fixed-K key set, inference forward.
//
// Replaces the TPU kernel fused_st_attention
// (pointcloudpdf_tpu/ops/pallas_st_attention.py, _st_kernel).  Per query i
// and head h, over its K key slots j (key_mask false -> probability 0):
//   bin[a] = clip(floor(((c_i[a] - c_j[a]) + 2 ws) - 1e-4) / quant), 0, 2L-1)
//   logit  = s q_i . k_j + sum_a s q_i . Tq[a][bin[a]] + sum_a k_j . Tk[a][bin[a]]
//   out_i  = sum_j softmax_j(logit) * (v_j + sum_a Tv[a][bin[a]])
// with every dot over the 16 channels of head h and s = 16^-0.5 applied to q
// once.  A query with no valid key comes out 0.  Tables are (3, 2L, C); a
// null table switches its term off.
//
// Bound on the card: operations by the count (15 C + 6 H + 15 flop a valid
// pair against ~16 C bytes a query), but what the kernel waits for is the gather: per
// valid key it reads one k row, one v row and up to nine table rows by
// index.  The tables (9 x 2L x C floats: 221 KB at C = 96, 885 KB at
// C = 384) do not fit a block's shared memory, so table rows are read from
// device memory, where they stay hot in L2.  Design: one warp per query,
// lane l owning channels l + 32 r; a head is 16 consecutive channels, so the
// head's dot is a half-warp butterfly and both halves of a warp reduce two
// heads at once; the softmax over K runs online, so a lane keeps three
// floats a round (max, sum, weighted value) and no K x H logits; key and
// table rows are gathered inside the kernel (no payload slab).  The bin
// arithmetic is the plain version's, operation for operation and without
// FMA contraction (a true division, not a multiplication by 1/quant), so
// kernel and plain version pick the same bins.  Sums are in f32.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <int R>  // rounds: C = 32 R channels, 2 R heads of 16
__global__ void __launch_bounds__(kWarps * 32)
st_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ coord,
                    const int* __restrict__ key_idx,
                    const uint8_t* __restrict__ key_mask,
                    const float* __restrict__ tq, const float* __restrict__ tk,
                    const float* __restrict__ tv, float scale, float two_ws,
                    float eps, float quant, int B, int N, int K, int L2,
                    float* __restrict__ out) {
  constexpr int C = 32 * R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long M = (long long)B * N;
  const float top = (float)(L2 - 1);
  for (long long m = (long long)blockIdx.x * kWarps + warp; m < M;
       m += (long long)gridDim.x * kWarps) {
    const long long base = (m / N) * N;
    float qs[R], run_max[R], run_sum[R], acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      qs[r] = q[m * C + lane + 32 * r] * scale;
      run_max[r] = -INFINITY;
      run_sum[r] = 0.f;
      acc[r] = 0.f;
    }
    const float cq[3] = {coord[m * 3 + 0], coord[m * 3 + 1], coord[m * 3 + 2]};

    for (int kk = 0; kk < K; ++kk) {
      if (!key_mask[m * K + kk]) continue;  // warp-uniform
      const long long row = base + key_idx[m * K + kk];
      // table row offsets of the three axes
      long long off[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float rel = __fsub_rn(cq[a], coord[row * 3 + a]);
        const float t = __fsub_rn(__fadd_rn(rel, two_ws), eps);
        const float bin = fminf(fmaxf(floorf(__fdiv_rn(t, quant)), 0.f), top);
        off[a] = ((long long)a * L2 + (int)bin) * C;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        const float kc = k[row * C + c];
        float p = qs[r] * kc;
        if (tq != nullptr)
          p += qs[r] * (tq[off[0] + c] + tq[off[1] + c] + tq[off[2] + c]);
        if (tk != nullptr)
          p += kc * (tk[off[0] + c] + tk[off[1] + c] + tk[off[2] + c]);
        // the head's logit: sum over its 16 lanes
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        float val = v[row * C + c];
        if (tv != nullptr)
          val += tv[off[0] + c] + tv[off[1] + c] + tv[off[2] + c];
        const float new_max = fmaxf(run_max[r], p);
        const float keep = expf(run_max[r] - new_max);
        const float e = expf(p - new_max);
        run_sum[r] = run_sum[r] * keep + e;
        acc[r] = acc[r] * keep + e * val;
        run_max[r] = new_max;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      out[m * C + lane + 32 * r] = run_sum[r] > 0.f ? acc[r] / run_sum[r] : 0.f;
  }
}

template <int R>
int launch(const float* q, const float* k, const float* v, const float* coord,
           const int* key_idx, const uint8_t* key_mask, const float* tq,
           const float* tk, const float* tv, float scale, float two_ws,
           float eps, float quant, int B, int N, int K, int L2, float* out,
           cudaStream_t stream) {
  const long long M = (long long)B * N;
  const long long blocks = (M + kWarps - 1) / kWarps;
  const int grid = (int)(blocks < 16384 ? blocks : 16384);
  st_attention_kernel<R><<<grid, kWarps * 32, 0, stream>>>(
      q, k, v, coord, key_idx, key_mask, tq, tk, tv, scale, two_ws, eps, quant,
      B, N, K, L2, out);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v (B, N, C) f32, coord (B, N, 3) f32, key_idx (B, N, K) i32 rows of
// the same sample, key_mask (B, N, K) u8, tq/tk/tv (3, L2, C) f32 or null
// -> out (B, N, C) f32.  Head width 16; C in {32, 64, 96, 128, 192, 256,
// 384, 512}.
extern "C" int pcpdf_st_attention(
    const void* q, const void* k, const void* v, const void* coord,
    const void* key_idx, const void* key_mask, const void* tq, const void* tk,
    const void* tv, float scale, float two_ws, float eps, float quant, int B,
    int N, int C, int K, int L2, void* out, void* stream) {
  if ((long long)B * N == 0) return 0;
  if (L2 < 1 || K < 0) return (int)cudaErrorInvalidValue;
#define PCPDF_ST_LAUNCH(R)                                                   \
  case 32 * R:                                                               \
    return launch<R>(                                                        \
        static_cast<const float*>(q), static_cast<const float*>(k),         \
        static_cast<const float*>(v), static_cast<const float*>(coord),     \
        static_cast<const int*>(key_idx),                                    \
        static_cast<const uint8_t*>(key_mask), static_cast<const float*>(tq), \
        static_cast<const float*>(tk), static_cast<const float*>(tv), scale, \
        two_ws, eps, quant, B, N, K, L2, static_cast<float*>(out),          \
        static_cast<cudaStream_t>(stream));
  switch (C) {
    PCPDF_ST_LAUNCH(1)
    PCPDF_ST_LAUNCH(2)
    PCPDF_ST_LAUNCH(3)
    PCPDF_ST_LAUNCH(4)
    PCPDF_ST_LAUNCH(6)
    PCPDF_ST_LAUNCH(8)
    PCPDF_ST_LAUNCH(12)
    PCPDF_ST_LAUNCH(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PCPDF_ST_LAUNCH
}
