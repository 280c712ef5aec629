// K2: exact farthest point sampling, in two kernels chosen by set size.
//
// Replaces the TPU kernel farthest_point_sampling_pallas
// (pointcloudpdf_tpu/ops/pallas_fps.py, _fps_kernel).  The port's
// sampling.py runs FPS in two modes: exact FPS over a whole sample (one set
// per sample, any mask) and blocked FPS, where every morton window of a
// sample is its own set (TransitionDown: windows of 256 points with 64
// picks; the ST key sets and downsamplings: 512 or 1,024 points with 128).
//
// Bound on the card: latency, not bytes or arithmetic.  FPS is m dependent
// rounds, each a pass over the set and an argmax over it, so the cost is m
// times (one pass + the argmax's latency).
//
// fps_windows_kernel (blocked mode, windows of up to kWindowMax points):
// one warp a window (8 points a lane for the 256-point windows of PT-v1,
// 16 and 32 for ST's 512 and 1,024).  It reads its window's rows of the
// morton-sorted sample in place (start, quota and validity computed from
// the sample's valid count as sampling.fps_windows_plain does) and writes
// the picks' sorted positions, so the blocked call gathers no window copy
// and builds no window tensors.  A lane keeps its consecutive slots'
// coordinates and running distances in registers; the window's
// coordinates also sit once in shared memory, from where the last pick's
// are a broadcast read.  A round is the lane's distance updates and its
// local best (a tree in slot order), then the warp's argmax with no
// barrier: the max of a key (a valid distance's float bits + 1, a masked
// point 0) by redux.sync, then the lowest lane that holds it (a ballot),
// which holds the lowest such slot, and its slot by a shuffle.
//
// fps_kernel (exact mode, and windows above kWindowMax points): one block
// per set, one thread a point (up to 1,024 threads) and a block-wide argmax
// behind two barriers a round; a set of up to kSmemPoints points keeps its
// coordinates and running distances in shared memory for all m rounds, a
// larger set in device memory (a scratch buffer the wrapper allocates),
// where they stay in the 50 MB L2.
//
// Rules kept from the reference (ops/sampling.py): running distance starts
// at 1e10 for valid points and -inf for masked ones, so a masked point is
// never picked while a valid one is left; the first pick is index 0; the
// argmax takes the lowest index on ties, as jnp.argmax does, and index 0
// when no point of the set is valid.

#include "common.cuh"

namespace {

constexpr int kSmemPoints = 8192;  // 16 B each: 128 KB of shared memory
constexpr int kWindowMax = 1024;  // one warp a window: 8, 16 or 32 points a lane

struct ValIdx {
  float v;
  int i;
};

// larger value wins; equal values -> lower index
__device__ __forceinline__ ValIdx better(ValIdx a, ValIdx b) {
  if (b.v > a.v || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

__device__ __forceinline__ ValIdx warp_argmax(ValIdx x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ValIdx o;
    o.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, x.i, off);
    x = better(x, o);
  }
  return x;
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           const uint8_t* __restrict__ mask, int n, int m,
                           bool in_smem, float* __restrict__ scratch,
                           int* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ ValIdx warp_best[32];
  __shared__ int picked;

  const int set = blockIdx.x;
  const float* gx = xyz + (size_t)set * n * 3;
  const uint8_t* gm = mask + (size_t)set * n;
  int* o = out + (size_t)set * m;

  // layout: x[n] y[n] z[n] dist[n], in shared or device memory
  float *x, *y, *z, *dist;
  if (in_smem) {
    x = smem;
    y = smem + n;
    z = smem + 2 * n;
    dist = smem + 3 * n;
  } else {
    x = scratch + (size_t)set * n * 4;
    y = x + n;
    z = x + 2 * n;
    dist = x + 3 * n;
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    x[p] = gx[p * 3 + 0];
    y[p] = gx[p * 3 + 1];
    z[p] = gx[p * 3 + 2];
    dist[p] = gm[p] ? 1e10f : -INFINITY;
  }
  if (threadIdx.x == 0) {
    picked = 0;
    o[0] = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  for (int r = 1; r < m; ++r) {
    const int last = picked;
    const float lx = x[last], ly = y[last], lz = z[last];
    ValIdx best{-INFINITY, 0x7fffffff};
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const float d = fminf(dist[p], pcpdf::dist2(x[p], y[p], z[p], lx, ly, lz));
      dist[p] = d;
      if (d > best.v || (d == best.v && p < best.i)) best = ValIdx{d, p};
    }
    best = warp_argmax(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();  // every thread has read `picked` and written dist
    if (warp == 0) {
      ValIdx w = lane < n_warps ? warp_best[lane] : ValIdx{-INFINITY, 0x7fffffff};
      w = warp_argmax(w);
      if (lane == 0) {
        picked = w.i;
        o[r] = w.i;
      }
    }
    __syncthreads();
  }
}


// sorted (B, N, 3) rows of the morton-sorted samples, count (B,) valid rows
// of each (a prefix) -> pos (B, G k_g): window gi of sample b covers the
// rows start + s, s < g, start = min(gi q, max(v - q, 0)), q = ceil(v / G);
// slot s is valid where s < q and start + s < v, and its row is clamped to
// N - 1.  Block = one warp = one window of g <= 32 PPL slots; lane l holds
// the slots l PPL + j, j < PPL, so a lower lane holds lower slots.
template <int PPL>
__global__ void __launch_bounds__(32)
fps_windows_kernel(const float* __restrict__ sorted,
                   const int* __restrict__ count, int N, int G, int g,
                   int k_g, long long* __restrict__ pos) {
  __shared__ float4 pts[32 * PPL];  // the window, for the picked point

  const int b = blockIdx.x / G;
  const int gi = blockIdx.x - b * G;
  const int v = count[b];
  const int q = (v + G - 1) / G;
  const int start = min(gi * q, max(v - q, 0));
  const float* src = sorted + (size_t)b * N * 3;
  long long* o = pos + (size_t)blockIdx.x * k_g;

  const int lane = threadIdx.x;
  const int first = lane * PPL;  // the slot of the lane's point j = 0
  float x[PPL], y[PPL], z[PPL], dist[PPL];
#pragma unroll
  for (int j = 0; j < PPL; ++j) {
    const int s = first + j;
    const int row = min(start + s, N - 1);
    x[j] = s < g ? src[row * 3 + 0] : 0.f;
    y[j] = s < g ? src[row * 3 + 1] : 0.f;
    z[j] = s < g ? src[row * 3 + 2] : 0.f;
    pts[s] = make_float4(x[j], y[j], z[j], 0.f);
    dist[j] = (s < g && s < q && start + s < v) ? 1e10f : -INFINITY;
  }
  if (lane == 0) o[0] = min(start, N - 1);
  __syncwarp();

  int slot = 0;  // the first pick
  for (int r = 1; r < k_g; ++r) {
    const float4 c = pts[slot];
    // the lane's best: its distances updated, then a tree in slot order
    // (the larger distance wins, an equal one keeps the lower slot)
    float d[PPL];
    int jj[PPL];
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      dist[j] = fminf(dist[j], pcpdf::dist2(x[j], y[j], z[j], c.x, c.y, c.z));
      d[j] = dist[j];
      jj[j] = j;
    }
#pragma unroll
    for (int step = 1; step < PPL; step *= 2)
#pragma unroll
      for (int j = 0; j < PPL; j += 2 * step)
        if (d[j + step] > d[j]) d[j] = d[j + step], jj[j] = jj[j + step];
    // the warp's: the largest key (a valid distance's bits + 1, a masked
    // point 0) by redux.sync, then the lowest lane that holds it, which
    // holds the lowest such slot
    const unsigned key = d[0] >= 0.f ? __float_as_uint(d[0]) + 1u : 0u;
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    const int owner = __ffs(__ballot_sync(0xffffffffu, key == top)) - 1;
    slot = owner * PPL + __shfl_sync(0xffffffffu, jj[0], owner);
    if (lane == 0) o[r] = min(start + slot, N - 1);
  }
}

template <int PPL>
int launch_windows(const void* sorted, const void* count, int B, int N, int G,
                   int g, int k_g, void* pos, cudaStream_t stream) {
  fps_windows_kernel<PPL><<<B * G, 32, 0, stream>>>(
      static_cast<const float*>(sorted), static_cast<const int*>(count), N, G, g,
      k_g, static_cast<long long*>(pos));
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (S, n, 3) f32, mask (S, n) u8 -> out (S, m) i32.  scratch: (S, 4n)
// f32 when n > kSmemPoints, else unused (may be null).
extern "C" int pcpdf_fps(const void* xyz, const void* mask, int S, int n,
                         int m, void* scratch, void* out, void* stream) {
  if (S == 0 || m == 0) return 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const bool in_smem = n <= kSmemPoints;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  const size_t smem = in_smem ? (size_t)n * 4 * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kSmemPoints * 4 * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const uint8_t*>(mask), n, m,
      in_smem, static_cast<float*>(scratch), static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// sorted (B, N, 3) f32, count (B,) i32 -> pos (B, G k_g) i64: blocked FPS
// over every sample's G windows of g sorted rows, k_g picks each, g <=
// kWindowMax (larger windows go through pcpdf_fps).
extern "C" int pcpdf_fps_windows(const void* sorted, const void* count, int B,
                                 int N, int G, int g, int k_g, void* pos,
                                 void* stream) {
  if (B == 0 || G == 0 || k_g == 0) return 0;
  if (N < 1 || g < 1 || g > kWindowMax) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g <= 256) return launch_windows<8>(sorted, count, B, N, G, g, k_g, pos, st);
  if (g <= 512) return launch_windows<16>(sorted, count, B, N, G, g, k_g, pos, st);
  return launch_windows<32>(sorted, count, B, N, G, g, k_g, pos, st);
}
