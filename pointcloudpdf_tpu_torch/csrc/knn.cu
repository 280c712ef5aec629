// K1: exact k-nearest-neighbour search over padded point sets.
//
// Replaces the TPU kernels knn_pallas / _knn_pallas_pruned
// (pointcloudpdf_tpu/ops/pallas_knn.py, _knn_kernel and
// _knn_kernel_pruned).  Those fold each ref chunk to strided-group minima
// and so miss ~0.5% of neighbours; both kernels here are exact: dist2 equals
// the plain version's bit for bit, and on equal distances the lower ref
// index wins.
//
// Two kernels, chosen by the size of the ref set (ops/geometry.py,
// KNN_PRUNE_MIN_REFS):
//
// knn_kernel, brute force, for small sets.  Every query against every ref,
// N*M distance evaluations over 16*N bytes of coordinates: bound by
// operations.  One thread per query keeps its sorted top-K_MAX in registers
// (K_MAX is the power of two at or above k and a template parameter, so the
// insertion network unrolls into register moves; the first k of the sorted
// K_MAX are the top-k); the block stages tiles of refs through shared
// memory.  Refs are scanned in index order and a candidate displaces an
// entry only when strictly nearer.
//
// knn_kernel_pruned, the TPU kernel's algorithm made exact, for large sets.
// Brute force spends its time on pairs that cannot win: a query's k nearest
// lie within a few cm, the ref set spans metres.  Prep (knn_prep_*, with one
// flat sort of b << 32 | code between them, launched by the wrapper): both
// sides are ordered by morton code (masked refs last) and the sorted refs
// are cut into chunks of R, each with the bounding box of its valid refs.
// One warp takes a tile of 32 consecutive sorted queries, one lane each, and
// runs alone (no block-wide barrier): a tile that must search far holds up
// only itself.  It forms its box and, for every chunk, a lower bound on the
// squared distance of any (query, ref) pair of the two boxes,
//   gap = max(0, lo_a - hi_b, lo_b - hi_a) per axis,
//   lb = (gap_x*gap_x + gap_y*gap_y) + gap_z*gap_z,
// in the same correctly rounded operations and association as pcpdf::dist2.
// Rounding to nearest is monotone, so lb <= dist2 of every such pair, bit
// for bit: no margin is needed.  The warp keeps its bounds in shared
// memory and visits the chunks in ascending bound (a warp argmin a step;
// ties go to the chunk nearest its own place in the order), and stops at
// the first whose bound is strictly greater than tau, the largest current
// k-th distance of its queries (+inf while any has fewer than k
// candidates): that chunk cannot hold a winner, nor can any after it.  A
// chunk at lb == tau is visited, since a tie there can still win on index.
// Inside a visited chunk, runs of 32 refs have boxes of their own, and the
// warp skips a run when the bound from each of its queries to the run's box
// exceeds that query's k-th distance.
// Candidates come in sorted order, so the insertion compares (dist2,
// original index) lexicographically and keeps the brute kernel's order.
// Runs of equal queries (a bucket's zero padding, duplicate points) are
// searched once, by the tile that holds the run's start, which writes the
// run's rows; with self kNN the valid and the masked queries never share a
// tile.  What bounds it then: the visited share of the pair work (a few
// percent on room-scale clouds at N = 65,536), the register insertion, the
// tiles that must search far (large boxes across a jump of the z-order),
// and the prep (two passes over the coordinates and a sort a side).

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // refs staged per shared-memory tile

template <int K_MAX>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           const uint8_t* __restrict__ ref_mask, int M, int N, int k,
           int* __restrict__ idx_out, float* __restrict__ dist_out) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < M;

  const float* qp = query + ((size_t)b * M + (active ? q : 0)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  float bd[K_MAX];
  int bi[K_MAX];
#pragma unroll
  for (int s = 0; s < K_MAX; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }

  const float* rb = ref + (size_t)b * N * 3;
  const uint8_t* mb = ref_mask + (size_t)b * N;
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn = min(kTile, N - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < tn; j += kThreads) {
      const float* r = rb + (size_t)(t0 + j) * 3;
      tile[j] = make_float4(r[0], r[1], r[2], mb[t0 + j] ? 1.0f : 0.0f);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < tn; ++j) {
      const float4 r = tile[j];
      if (r.w == 0.0f) continue;
      const float d = pcpdf::dist2(r.x, r.y, r.z, qx, qy, qz);
      if (!(d < bd[K_MAX - 1])) continue;
      const int jj = t0 + j;
      // insertion: shift every entry that is strictly farther one slot
      // down, then drop the candidate into the hole
      bool placed = false;
#pragma unroll
      for (int s = K_MAX - 1; s > 0; --s) {
        if (!placed) {
          if (d < bd[s - 1]) {
            bd[s] = bd[s - 1];
            bi[s] = bi[s - 1];
          } else {
            bd[s] = d;
            bi[s] = jj;
            placed = true;
          }
        }
      }
      if (!placed) {
        bd[0] = d;
        bi[0] = jj;
      }
    }
  }
  if (!active) return;
  // slots past the valid refs keep +inf and repeat the nearest index (or
  // 0 when there is none), so every index is a safe gather row
  const int first = bi[0] >= 0 ? bi[0] : 0;
  int* io = idx_out + ((size_t)b * M + q) * k;
  float* dout = dist_out + ((size_t)b * M + q) * k;
#pragma unroll
  for (int s = 0; s < K_MAX; ++s) {
    if (s < k) {
      io[s] = bi[s] >= 0 ? bi[s] : first;
      dout[s] = bd[s];
    }
  }
}

template <int K_MAX>
void launch(const float* query, const float* ref, const uint8_t* mask, int B,
            int M, int N, int k, int* idx, float* dist, cudaStream_t stream) {
  dim3 grid((M + kThreads - 1) / kThreads, B);
  knn_kernel<K_MAX><<<grid, kThreads, 0, stream>>>(query, ref, mask, M, N, k,
                                                   idx, dist);
}

// ---------------------------------------------------------------------------
// the bound-pruned kernel and its prep

constexpr int kPrepThreads = 256;
constexpr int kBoxParts = 32;    // blocks a sample in the bounding-box pass
constexpr int kMaxChunk = 256;   // largest chunk of sorted refs (R)
constexpr int kWarp = 32;        // a tile of sorted queries: one warp
constexpr int kPrunedWarps = 4;  // warps (tiles) a block of the pruned kernel
constexpr int kMortonMax = 1023;    // 10 bits an axis
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void box_warp_reduce(float (&box)[6]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], __shfl_xor_sync(kFull, box[a], off));
      box[a + 3] = fmaxf(box[a + 3], __shfl_xor_sync(kFull, box[a + 3], off));
    }
  }
}

// the box (lo xyz, hi xyz) of a block's threads into ``out`` (every thread
// gets it); ``scratch`` holds 6 x (blockDim / 32) floats
__device__ __forceinline__ void box_block_reduce(float (&box)[6], float* scratch,
                                                 float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  box_warp_reduce(box);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) scratch[a * warps + warp] = box[a];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float v = scratch[a * warps];
    for (int w = 1; w < warps; ++w)
      v = a < 3 ? fminf(v, scratch[a * warps + w]) : fmaxf(v, scratch[a * warps + w]);
    out[a] = v;
  }
}

// part[b][g] = (lo xyz, hi xyz, count of valid points as int bits, 0) over
// the g-th strided share of sample b; mask NULL: every point is valid
__global__ void __launch_bounds__(kPrepThreads)
knn_prep_box(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
             int N, float* __restrict__ part) {
  __shared__ float scratch[6 * kPrepThreads / 32];
  __shared__ int count;
  const int b = blockIdx.y;
  float box[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int cnt = 0;
  if (threadIdx.x == 0) count = 0;
  for (int i = blockIdx.x * kPrepThreads + threadIdx.x; i < N;
       i += kBoxParts * kPrepThreads) {
    if (mask != nullptr && !mask[(size_t)b * N + i]) continue;
    const float* p = xyz + ((size_t)b * N + i) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], p[a]);
      box[a + 3] = fmaxf(box[a + 3], p[a]);
    }
    ++cnt;
  }
  float out[6];
  box_block_reduce(box, scratch, out);  // synchronises after count = 0
  atomicAdd(&count, cnt);
  __syncthreads();
  if (threadIdx.x == 0) {
    float* o = part + ((size_t)b * kBoxParts + blockIdx.x) * 8;
#pragma unroll
    for (int a = 0; a < 6; ++a) o[a] = out[a];
    o[6] = __int_as_float(count);
    o[7] = 0.0f;
  }
}

__device__ __forceinline__ unsigned part1by2(unsigned x) {
  x &= 0x3FF;
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

// keys[b][i] = b << 32 | the morton code of point i on sample b's valid
// bounding box, rounded as ops/serialization.py morton_codes rounds it
// (masked points: the sentinel 0xFFFFFFFF), so that one flat sort orders
// every sample at once.  n_valid[b] (when not NULL): the valid count.
__global__ void __launch_bounds__(kPrepThreads)
knn_prep_codes(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
               int N, const float* __restrict__ part,
               int64_t* __restrict__ keys, int* __restrict__ n_valid) {
  __shared__ float box[6];
  const int b = blockIdx.y;
  if (threadIdx.x < 32) {
    // kBoxParts == 32: one partial box a lane
    const float* p = part + ((size_t)b * kBoxParts + threadIdx.x) * 8;
    float v[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) v[a] = p[a];
    int cnt = __float_as_int(p[6]);
    box_warp_reduce(v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFull, cnt, off);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int a = 0; a < 6; ++a) box[a] = v[a];
      if (n_valid != nullptr && blockIdx.x == 0) n_valid[b] = cnt;
    }
  }
  __syncthreads();
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  if (i >= N) return;
  int64_t* out = keys + (size_t)b * N + i;
  if (mask != nullptr && !mask[(size_t)b * N + i]) {
    *out = ((int64_t)b << 32) | 0xFFFFFFFFll;
    return;
  }
  const float extent = fmaxf(
      fmaxf(fmaxf(__fsub_rn(box[3], box[0]), __fsub_rn(box[4], box[1])),
            __fsub_rn(box[5], box[2])),
      1e-6f);
  const float scale = __fmul_rn(__frcp_rn(extent), (float)kMortonMax);
  const float* p = xyz + ((size_t)b * N + i) * 3;
  unsigned code = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float g = __fmul_rn(__fsub_rn(p[a], box[a]), scale);
    g = fminf(fmaxf(g, 0.0f), (float)kMortonMax);
    code |= part1by2((unsigned)(int)g) << a;
  }
  *out = ((int64_t)b << 32) | code;
}

// sorted[b][p] = (xyz, original index as int bits) of ref order[b][p] - b * N
// (the flat order of the sorted keys); boxes[b][c] = the bounding box of
// the valid refs of chunk c (+inf / -inf when it has none), sub_boxes[b][s]
// the same of each run of 32.  One block of R threads a chunk.
__global__ void __launch_bounds__(kMaxChunk)
knn_prep_chunks(const float* __restrict__ ref, const uint8_t* __restrict__ mask,
                const int64_t* __restrict__ order, int N, int n_chunks,
                float4* __restrict__ sorted, float* __restrict__ boxes,
                float* __restrict__ sub_boxes) {
  __shared__ float scratch[6 * kMaxChunk / 32];
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float box[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if (p < N) {
    const int src = (int)(order[(size_t)b * N + p] - (int64_t)b * N);
    const float* r = ref + ((size_t)b * N + src) * 3;
    const float x = r[0], y = r[1], z = r[2];
    sorted[(size_t)b * N + p] = make_float4(x, y, z, __int_as_float(src));
    if (mask[(size_t)b * N + src]) {
      box[0] = box[3] = x;
      box[1] = box[4] = y;
      box[2] = box[5] = z;
    }
  }
  box_warp_reduce(box);
  if ((threadIdx.x & 31) == 0) {
    float* o = sub_boxes + ((size_t)b * n_chunks * (blockDim.x >> 5) + (p >> 5)) * 6;
#pragma unroll
    for (int a = 0; a < 6; ++a) o[a] = box[a];
  }
  float out[6];
  box_block_reduce(box, scratch, out);
  if (threadIdx.x < 6)
    boxes[((size_t)b * n_chunks + blockIdx.x) * 6 + threadIdx.x] = out[threadIdx.x];
}

__device__ __forceinline__ float axis_gap(float a_lo, float a_hi, float b_lo,
                                          float b_hi) {
  return fmaxf(0.0f, fmaxf(__fsub_rn(a_lo, b_hi), __fsub_rn(b_lo, a_hi)));
}

// lower bound on dist2 between any point of box a and any point of box b
// (each lo xyz, hi xyz), rounded as pcpdf::dist2
__device__ __forceinline__ float box_bound(const float* a, const float* b) {
  const float gx = axis_gap(a[0], a[3], b[0], b[3]);
  const float gy = axis_gap(a[1], a[4], b[1], b[4]);
  const float gz = axis_gap(a[2], a[5], b[2], b[5]);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

__device__ __forceinline__ bool lex_less(float d, int j, float bd, int bj) {
  return d < bd || (d == bd && j < bj);
}

// the chunk to visit first of two: the lesser bound, then the nearer to
// the tile's home chunk, then the lower index (INT_MAX: none)
__device__ __forceinline__ bool visit_first(float m1, int a1, float m2, int a2,
                                            int home) {
  if (m1 != m2) return m1 < m2;
  const int d1 = abs(a1 - home), d2 = abs(a2 - home);
  return d1 < d2 || (d1 == d2 && a1 < a2);
}

// the tile of warp t of sample b: sorted query positions [p0, p1).  With
// ``same`` the valid queries (the first nv of the refs' order) and the
// masked ones get tiles of their own, so no tile mixes the two; the grid
// has one tile to spare for that split.
__device__ __forceinline__ void tile_rows(int t, int M, int nv, bool same,
                                          int& p0, int& p1) {
  const int split = same ? nv : M;
  const int head = (split + kWarp - 1) / kWarp;
  if (t < head) {
    p0 = t * kWarp;
    p1 = min(p0 + kWarp, split);
  } else {
    p0 = split + (t - head) * kWarp;
    p1 = min(p0 + kWarp, M);
  }
}

template <int K_MAX>
__global__ void __launch_bounds__(kPrunedWarps * kWarp)
knn_kernel_pruned(const float* __restrict__ query,
                  const int64_t* __restrict__ query_order,
                  const float4* __restrict__ refs, const float* __restrict__ boxes,
                  const float* __restrict__ sub_boxes,
                  const int* __restrict__ n_valid, int same, int M, int N,
                  int n_chunks, int R, int tiles, int k, int* __restrict__ idx_out,
                  float* __restrict__ dist_out, int* __restrict__ visits) {
  // per warp: the staged chunk (R float4), then the bounds of its tile to
  // every chunk (n_chunks floats, rounded up to whole float4)
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kPrunedWarps + warp;
  const int b = blockIdx.y;
  if (t >= tiles) return;  // no block-wide barrier below: warps run alone
  float4* stage = smem + (size_t)warp * (R + (n_chunks + 3) / 4);
  float* lb = reinterpret_cast<float*>(stage + R);

  const int nv = n_valid[b];
  int p0, p1;
  tile_rows(t, M, nv, same != 0, p0, p1);
  if (p0 >= p1) {  // the spare tile
    if (visits != nullptr && lane == 0) visits[(size_t)b * tiles + t] = 0;
    return;
  }
  const int64_t* order = query_order + (size_t)b * M;
  const float* qb = query + (size_t)b * M * 3;
  const int p = p0 + lane;
  bool active = p < p1;
  int q = 0;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    q = (int)(order[p] - (int64_t)b * M);
    qx = qb[q * 3];
    qy = qb[q * 3 + 1];
    qz = qb[q * 3 + 2];
  }
  // Runs of equal queries (the padded tail of a bucket, duplicate points)
  // are searched once: a lane whose query equals every query back to the one
  // before its tile is deferred, and the warp that holds the run's start
  // writes its rows (below).  The tile's box and tau leave deferred lanes out.
  {
    float px = __shfl_up_sync(kFull, qx, 1), py = __shfl_up_sync(kFull, qy, 1),
          pz = __shfl_up_sync(kFull, qz, 1);
    if (lane == 0 && p0 > 0) {
      const int pq = (int)(order[p0 - 1] - (int64_t)b * M);
      px = qb[pq * 3];
      py = qb[pq * 3 + 1];
      pz = qb[pq * 3 + 2];
    }
    const bool eq = active && p > 0 && qx == px && qy == py && qz == pz;
    const unsigned run = __ballot_sync(kFull, eq);
    if ((~run & ((2u << lane) - 1u)) == 0) active = false;  // lanes 0..lane all equal
  }
  if (!__any_sync(kFull, active)) {
    if (visits != nullptr && lane == 0) visits[(size_t)b * tiles + t] = 0;
    return;
  }
  float tbox[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if (active) {
    tbox[0] = tbox[3] = qx;
    tbox[1] = tbox[4] = qy;
    tbox[2] = tbox[5] = qz;
  }
  box_warp_reduce(tbox);

  const int nc = (nv + R - 1) / R;
  // the chunk holding the tile's own sorted position (self kNN), or the
  // chunk at the same share of the order: ties of the bound go nearest it
  const int home = min(same ? p0 / R : (int)((long long)p0 * nc / M), max(nc - 1, 0));
  const float* bb = boxes + (size_t)b * n_chunks * 6;
  // each lane owns the chunks c = lane (mod 32), and keeps the one of them
  // to visit first
  float my_min = INFINITY;
  int my_arg = INT_MAX;
  for (int c = lane; c < nc; c += kWarp) {
    const float l = box_bound(tbox, bb + (size_t)c * 6);
    lb[c] = l;
    if (l < INFINITY && visit_first(l, c, my_min, my_arg, home)) {
      my_min = l;
      my_arg = c;
    }
  }

  float bd[K_MAX];
  int bi[K_MAX];
#pragma unroll
  for (int s = 0; s < K_MAX; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }
  float kd = INFINITY;  // the current k-th (dist2, index)
  int ki = -1;
  int visited = 0;
  const float4* rb = refs + (size_t)b * N;

  for (;;) {
    // the unvisited chunk to visit first, and tau
    float m = my_min, tau = active ? kd : -INFINITY;
    int a = my_arg;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(kFull, m, off);
      const int oa = __shfl_xor_sync(kFull, a, off);
      if (visit_first(om, oa, m, a, home)) {
        m = om;
        a = oa;
      }
      tau = fmaxf(tau, __shfl_xor_sync(kFull, tau, off));
    }
    // no chunk left, or the nearest cannot hold a winner: nor can the rest
    if (a == INT_MAX || m > tau) break;
    if (lane == (a & (kWarp - 1))) {
      lb[a] = INFINITY;
      my_min = INFINITY;
      my_arg = INT_MAX;
      for (int c = lane; c < nc; c += kWarp) {
        const float l = lb[c];
        if (l < INFINITY && visit_first(l, c, my_min, my_arg, home)) {
          my_min = l;
          my_arg = c;
        }
      }
    }
    const int base = a * R;
    const int cnt = min(R, nv - base);
    ++visited;
    // the runs of 32 refs that some query of the warp may still take: the
    // bound from its point to the run's box at most its k-th distance (k-th
    // distances only fall, so a run skipped now stays skippable)
    const float qbox[6] = {qx, qy, qz, qx, qy, qz};
    unsigned runs = 0;
    for (int s = 0; s * kWarp < cnt; ++s) {
      const float* sb = sub_boxes + ((size_t)b * n_chunks * (R / kWarp) + base / kWarp + s) * 6;
      if (__any_sync(kFull, active && !(box_bound(qbox, sb) > kd))) {
        runs |= 1u << s;
        if (base + s * kWarp + lane < nv)
          stage[s * kWarp + lane] = rb[base + s * kWarp + lane];
      }
    }
    __syncwarp();
    for (; runs != 0; runs &= runs - 1) {
      const int j0 = (__ffs(runs) - 1) * kWarp;
      const int j1 = min(j0 + kWarp, cnt);
      for (int j = j0; j < j1; ++j) {
        const float4 r = stage[j];
        const float d = pcpdf::dist2(r.x, r.y, r.z, qx, qy, qz);
        const int jj = __float_as_int(r.w);
        if (!lex_less(d, jj, kd, ki)) continue;
        // insertion by (dist2, index): slot s takes slot s-1's entry where
        // the candidate precedes both, the candidate where it precedes s
        // only.  The candidate precedes the k-th, so only slots below k
        // change what is returned.
        bool lt_s = lex_less(d, jj, bd[K_MAX - 1], bi[K_MAX - 1]);
#pragma unroll
        for (int s = K_MAX - 1; s > 0; --s) {
          const bool lt_prev = lex_less(d, jj, bd[s - 1], bi[s - 1]);
          if (lt_s) {
            bd[s] = lt_prev ? bd[s - 1] : d;
            bi[s] = lt_prev ? bi[s - 1] : jj;
          }
          if (s == k - 1) {
            kd = bd[s];
            ki = bi[s];
          }
          lt_s = lt_prev;
        }
        if (lt_s) {
          bd[0] = d;
          bi[0] = jj;
        }
        if (k == 1) {
          kd = bd[0];
          ki = bi[0];
        }
      }
    }
    __syncwarp();  // every lane is done with the staged chunk
  }
  if (visits != nullptr && lane == 0) visits[(size_t)b * tiles + t] = visited;
  // the last lane's run may go on past the tile: its rows get the last
  // lane's results, staged as (dist2, index) pairs
  const int last = p1 - 1 - p0;
  const float lx = __shfl_sync(kFull, qx, last), ly = __shfl_sync(kFull, qy, last),
              lz = __shfl_sync(kFull, qz, last);
  bool more = false;
  if (p1 < M) {
    const int nq = (int)(order[p1] - (int64_t)b * M);
    more = qb[nq * 3] == lx && qb[nq * 3 + 1] == ly && qb[nq * 3 + 2] == lz;
  }
  const int first = bi[0] >= 0 ? bi[0] : 0;
  float2* row = reinterpret_cast<float2*>(stage);
#pragma unroll
  for (int s = 0; s < K_MAX; ++s) {
    if (s < k) {
      const int i = bi[s] >= 0 ? bi[s] : first;
      if (active) {
        idx_out[((size_t)b * M + q) * k + s] = i;
        dist_out[((size_t)b * M + q) * k + s] = bd[s];
      }
      if (more && lane == last) row[s] = make_float2(bd[s], __int_as_float(i));
    }
  }
  if (!more) return;
  __syncwarp();
  for (int base = p1;; base += kWarp) {
    const int pos = base + lane;
    int rq = 0;
    bool eq = false;
    if (pos < M) {
      rq = (int)(order[pos] - (int64_t)b * M);
      eq = qb[rq * 3] == lx && qb[rq * 3 + 1] == ly && qb[rq * 3 + 2] == lz;
    }
    const unsigned ne = ~__ballot_sync(kFull, eq);
    const int n = ne ? __ffs(ne) - 1 : kWarp;  // the run goes on through lane n - 1
    if (lane < n) {
      for (int s = 0; s < k; ++s) {
        idx_out[((size_t)b * M + rq) * k + s] = __float_as_int(row[s].y);
        dist_out[((size_t)b * M + rq) * k + s] = row[s].x;
      }
    }
    if (n < kWarp) break;
  }
}

template <int K_MAX>
cudaError_t launch_pruned(const float* query, const int64_t* query_order,
                          const float4* refs, const float* boxes,
                          const float* sub_boxes, const int* n_valid, int same,
                          int B, int M, int N, int R, int tiles, int k, int* idx,
                          float* dist, int* visits, cudaStream_t stream) {
  const int n_chunks = (N + R - 1) / R;
  const size_t smem = (size_t)kPrunedWarps * (R + (n_chunks + 3) / 4) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel_pruned<K_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((tiles + kPrunedWarps - 1) / kPrunedWarps, B);
  knn_kernel_pruned<K_MAX><<<grid, kPrunedWarps * kWarp, smem, stream>>>(
      query, query_order, refs, boxes, sub_boxes, n_valid, same, M, N, n_chunks, R,
      tiles, k, idx, dist, visits);
  return cudaGetLastError();
}

}  // namespace

// query (B, M, 3) f32, ref (B, N, 3) f32, ref_mask (B, N) u8, 1 <= k <= N,
// k <= 64 -> idx (B, M, k) i32, dist2 (B, M, k) f32, ascending.
extern "C" int pcpdf_knn(const void* query, const void* ref,
                         const void* ref_mask, int B, int M, int N, int k,
                         void* idx, void* dist2, void* stream) {
  if (k < 1 || k > 64 || k > N) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return 0;
  auto q = static_cast<const float*>(query);
  auto r = static_cast<const float*>(ref);
  auto m = static_cast<const uint8_t*>(ref_mask);
  auto i = static_cast<int*>(idx);
  auto d = static_cast<float*>(dist2);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 4) launch<4>(q, r, m, B, M, N, k, i, d, s);
  else if (k <= 8) launch<8>(q, r, m, B, M, N, k, i, d, s);
  else if (k <= 16) launch<16>(q, r, m, B, M, N, k, i, d, s);
  else if (k <= 32) launch<32>(q, r, m, B, M, N, k, i, d, s);
  else launch<64>(q, r, m, B, M, N, k, i, d, s);
  return (int)cudaGetLastError();
}

// Prep, one side: xyz (B, N, 3) f32, mask (B, N) u8 or NULL (all valid),
// part (B, 32, 8) f32 scratch -> keys (B, N) i64 (b << 32 | the code of
// ops/serialization.py morton_codes), n_valid (B,) i32 or NULL.
extern "C" int pcpdf_knn_codes(const void* xyz, const void* mask, int B, int N,
                               void* part, void* keys, void* n_valid,
                               void* stream) {
  if (B == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xyz);
  auto m = static_cast<const uint8_t*>(mask);
  auto pt = static_cast<float*>(part);
  knn_prep_box<<<dim3(kBoxParts, B), kPrepThreads, 0, s>>>(x, m, N, pt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_prep_codes<<<dim3((N + kPrepThreads - 1) / kPrepThreads, B), kPrepThreads,
                   0, s>>>(x, m, N, pt, static_cast<int64_t*>(keys),
                           static_cast<int*>(n_valid));
  return (int)cudaGetLastError();
}

// Prep, the refs: ref (B, N, 3) f32, ref_mask (B, N) u8, order (B, N) i64
// (the flat sort of the keys: b * N + index, masked last), R refs a chunk (32 <= R <= 256, a multiple of
// 32) -> sorted (B, N, 4) f32 (xyz, original index as int bits), boxes
// (B, ceil(N / R), 6) f32, sub_boxes (B, ceil(N / R) * R / 32, 6) f32.
extern "C" int pcpdf_knn_chunks(const void* ref, const void* ref_mask,
                                const void* order, int B, int N, int R,
                                void* sorted, void* boxes, void* sub_boxes,
                                void* stream) {
  if (R < 32 || R > kMaxChunk || R % 32 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const int n_chunks = (N + R - 1) / R;
  knn_prep_chunks<<<dim3(n_chunks, B), R, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ref), static_cast<const uint8_t*>(ref_mask),
      static_cast<const int64_t*>(order), N, n_chunks, static_cast<float4*>(sorted),
      static_cast<float*>(boxes), static_cast<float*>(sub_boxes));
  return (int)cudaGetLastError();
}

// The bound-pruned search: query (B, M, 3) f32, query_order (B, M) i64 (the
// queries' flat morton order; with ``same`` the refs' order), sorted /
// boxes / sub_boxes from pcpdf_knn_chunks with chunk R, n_valid (B,) i32,
// 1 <= k <= 64 -> idx, dist2 as pcpdf_knn, in the caller's query order; visits (B,
// ceil(M / 32) + 1) i32 or NULL: the chunks each tile of 32 queries visited
// (tile_rows says which queries a tile holds).
extern "C" int pcpdf_knn_pruned(const void* query, const void* query_order,
                                const void* sorted, const void* boxes,
                                const void* sub_boxes, const void* n_valid,
                                int same, int B, int M, int N, int k, int R,
                                void* idx, void* dist2, void* visits,
                                void* stream) {
  if (k < 1 || k > 64 || k > N) return (int)cudaErrorInvalidValue;
  if (R < 32 || R > kMaxChunk || R % 32 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return 0;
  const int tiles = (M + kWarp - 1) / kWarp + 1;
  auto q = static_cast<const float*>(query);
  auto qp = static_cast<const int64_t*>(query_order);
  auto r = static_cast<const float4*>(sorted);
  auto bx = static_cast<const float*>(boxes);
  auto sb = static_cast<const float*>(sub_boxes);
  auto nv = static_cast<const int*>(n_valid);
  auto i = static_cast<int*>(idx);
  auto d = static_cast<float*>(dist2);
  auto v = static_cast<int*>(visits);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 4) err = launch_pruned<4>(q, qp, r, bx, sb, nv, same, B, M, N, R, tiles, k, i, d, v, s);
  else if (k <= 8) err = launch_pruned<8>(q, qp, r, bx, sb, nv, same, B, M, N, R, tiles, k, i, d, v, s);
  else if (k <= 16) err = launch_pruned<16>(q, qp, r, bx, sb, nv, same, B, M, N, R, tiles, k, i, d, v, s);
  else if (k <= 32) err = launch_pruned<32>(q, qp, r, bx, sb, nv, same, B, M, N, R, tiles, k, i, d, v, s);
  else err = launch_pruned<64>(q, qp, r, bx, sb, nv, same, B, M, N, R, tiles, k, i, d, v, s);
  return (int)err;
}
