// K6: kernel-point convolution (KPConv) over a neighbour table, inference
// forward.
//
// Replaces the TPU kernel band_kpconv (pointcloudpdf_tpu/ops/
// pallas_kpconv.py, _kpconv_kernel with its _sort_rank band).  Per point i,
// over its S neighbour slots j (nmask false -> no contribution):
//   infl[j][p] = max(0, 1 - |x_j - x_i - kp_p| / sigma_r)
//   y_i        = sum_p (sum_j infl[j][p] f_j) W_p
// The TPU kernel searches its neighbours itself, in a z-order rank band
// (uncapped, ~0.06% of in-radius pairs missed), because that chip has no
// cheap gather; here the table comes from the exact kNN kernel (the S
// nearest in-radius points) and rows are gathered by index, which is the
// JAX package's exact path.
//
// Bound on the card: operations by the count (per valid pair 12 P flop for
// the influences and 2 P C_in for the weighted features, per point
// 2 P C_in C_out for the product with W, against ~5 S + 4 C_out bytes a
// point), at sizes where the whole launch is tens of microseconds.  Design:
// one warp per point.  Lanes take neighbour slots and write the slot's P
// influences and its gathered feature row to the warp's shared memory;
// lanes then take (kernel point, input channel) pairs and sum over the
// slots; lanes then take output channels and multiply with W, which sits in
// shared memory for the block as (P C_in, C_out), so a warp's reads are
// consecutive.  No (N, S, P) or (N, P, C_in) tensor reaches device memory.
// Distances are direct differences, (dx*dx + dy*dy) + dz*dz without FMA
// contraction, as in the plain version.  Sums are in f32.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
kpconv_kernel(const float* __restrict__ coord, const float* __restrict__ feat,
              const int* __restrict__ idx, const uint8_t* __restrict__ nmask,
              const float* __restrict__ kp, const float* __restrict__ weight,
              float sigma_r, int B, int N, int S, int P, int Cin, int Cout,
              float* __restrict__ out) {
  extern __shared__ float smem[];
  const int PC = P * Cin;
  float* w_s = smem;                 // (P Cin, Cout)
  float* kp_s = w_s + PC * Cout;     // (P, 3)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* infl_s = kp_s + P * 3 + warp * (S * P + S * Cin + PC);  // (S, P)
  float* f_s = infl_s + S * P;                                   // (S, Cin)
  float* pk_s = f_s + S * Cin;                                   // (P, Cin)

  for (int i = threadIdx.x; i < PC * Cout; i += blockDim.x) w_s[i] = weight[i];
  for (int i = threadIdx.x; i < P * 3; i += blockDim.x) kp_s[i] = kp[i];
  __syncthreads();

  const long long M = (long long)B * N;
  for (long long m = (long long)blockIdx.x * kWarps + warp; m < M;
       m += (long long)gridDim.x * kWarps) {
    const long long base = (m / N) * N;
    const float cx = coord[m * 3 + 0], cy = coord[m * 3 + 1],
                cz = coord[m * 3 + 2];
    bool any = false;
    for (int s = lane; s < S; s += 32) {
      const bool valid = nmask[m * S + s] != 0;
      any |= valid;
      if (valid) {
        const long long row = base + idx[m * S + s];
        const float rx = __fsub_rn(coord[row * 3 + 0], cx);
        const float ry = __fsub_rn(coord[row * 3 + 1], cy);
        const float rz = __fsub_rn(coord[row * 3 + 2], cz);
        for (int p = 0; p < P; ++p) {
          const float d2 = pcpdf::dist2(rx, ry, rz, kp_s[p * 3 + 0],
                                        kp_s[p * 3 + 1], kp_s[p * 3 + 2]);
          const float dist = __fsqrt_rn(d2);
          infl_s[s * P + p] =
              fmaxf(__fsub_rn(1.0f, __fdiv_rn(dist, sigma_r)), 0.f);
        }
        for (int c = 0; c < Cin; ++c) f_s[s * Cin + c] = feat[row * Cin + c];
      } else {
        for (int p = 0; p < P; ++p) infl_s[s * P + p] = 0.f;
        for (int c = 0; c < Cin; ++c) f_s[s * Cin + c] = 0.f;
      }
    }
    any = __any_sync(0xffffffffu, any);
    if (!any) {  // warp-uniform: a padded point, or a point with no neighbour
      for (int d = lane; d < Cout; d += 32) out[m * Cout + d] = 0.f;
      continue;
    }
    __syncwarp();
    for (int e = lane; e < PC; e += 32) {
      const int p = e / Cin, c = e - p * Cin;
      float sum = 0.f;
      for (int s = 0; s < S; ++s) sum += infl_s[s * P + p] * f_s[s * Cin + c];
      pk_s[e] = sum;
    }
    __syncwarp();
    for (int d = lane; d < Cout; d += 32) {
      float sum = 0.f;
      for (int e = 0; e < PC; ++e) sum += pk_s[e] * w_s[e * Cout + d];
      out[m * Cout + d] = sum;
    }
    __syncwarp();  // the next point overwrites the warp's shared rows
  }
}

}  // namespace

// coord (B, N, 3) f32, feat (B, N, Cin) f32, idx (B, N, S) i32 rows of the
// same sample, nmask (B, N, S) u8, kp (P, 3) f32, weight (P, Cin, Cout) f32
// -> out (B, N, Cout) f32.  W and the warps' rows must fit a block's shared
// memory (227 KB).
extern "C" int pcpdf_kpconv(const void* coord, const void* feat,
                            const void* idx, const void* nmask, const void* kp,
                            const void* weight, float sigma_r, int B, int N,
                            int S, int P, int Cin, int Cout, void* out,
                            void* stream) {
  if ((long long)B * N == 0 || Cout == 0) return 0;
  if (S < 1 || P < 1 || Cin < 1) return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)P * Cin * Cout + (size_t)P * 3 +
                        (size_t)kWarps * ((size_t)S * P + (size_t)S * Cin +
                                          (size_t)P * Cin);
  const size_t smem = floats * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * N;
  const long long blocks = (M + kWarps - 1) / kWarps;
  const int grid = (int)(blocks < 16384 ? blocks : 16384);
  kpconv_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coord), static_cast<const float*>(feat),
      static_cast<const int*>(idx), static_cast<const uint8_t*>(nmask),
      static_cast<const float*>(kp), static_cast<const float*>(weight),
      sigma_r, B, N, S, P, Cin, Cout, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
