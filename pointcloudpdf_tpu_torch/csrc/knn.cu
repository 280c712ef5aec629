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
// knn_brute_kernel, brute force, for small sets.  Every query against every
// valid ref: N*M distance evaluations over 16*N bytes of coordinates, bound
// by operations (8 f32 a pair).  What held the one-thread-a-query kernel
// before it far under that bound was the layout, not the arithmetic: at
// serving's B = 1 a few thousand queries made a few dozen blocks of 4
// warps on a 132-SM card, each thread walking every ref through a chain of
// dependent loads.  Here:
// - a group of G lanes (a power of two, 1 to 32, inside one warp) serves a
//   query, lane l taking the compacted refs j = l (mod G).  The host
//   (pcpdf_knn_lanes) takes the fewest lanes that give the grid
//   kLaneWarps = 4 warps an SM (on an H100, 16,896 threads): G = 8 at
//   serving's 4,096 queries, 32 at 1,024 and 256, 2 at 16,384, 1 at the
//   train step's B = 16.  Each lane more splits a query's scan further but
//   adds a list to fill and to merge; the lane sweep of
//   tools/knn_compare_torch.py (PERF.md) put the best count at 2-8 warps
//   an SM at every phase-3 shape;
// - a block (kBruteThreads / G queries of one sample) compacts the sample's
//   valid refs into shared memory once, in index order, as (x, y, z,
//   original index as int bits), by a block-wide prefix count over the mask:
//   masked refs cost nothing after that, and the lanes of a group read
//   consecutive float4s.  Sets above kDirectRefs points stream through in
//   tiles of kTileRefs, the next tile's coordinates copied in by cp.async
//   while the lanes scan the current one;
// - a lane forms kUnroll distances, then their gates: it keeps its own
//   top-K_MAX in registers, sorted by (dist2, index) (K_MAX the power of
//   two at or above k, a template parameter, so the insertion network
//   unrolls into selects), and a candidate passes only when it comes
//   before its K_MAX-th and is not farther than tau, the group's gate:
//   the r-th least over the group's lanes of each lane's m-th distance
//   (m = min(k, ceil(2k / G)), r = ceil(k / m), a bitonic sort across the
//   group).  r lanes hold m refs each at or below tau, so a ref beyond it
//   cannot be among the k nearest; one at tau may still win on its index;
// - what bounds a lane is not the distances but the insertions and the
//   latency of each step: a sorted insert costs ~8 instructions a slot of
//   the list, and a warp whose lanes insert at different steps pays each
//   one.  So a candidate that passes goes to the thread's queue in shared
//   memory (kQueue slots), and the warp inserts all its queues at once when
//   one of them might overflow, then renews tau (the lists change only
//   there).  A warp visits its steps of kUnroll * G refs from a home step
//   (where its first query sits, by its share of the queries) in strides
//   coprime with their count: sampled sets come in z-order, and a scan in
//   that order draws near a query step by step, each nearer ref one more
//   insertion.  The step's loads are issued a step ahead.  With two to
//   four warps a scheduler at the main path's shapes, a step is bound by
//   its latency, not by issue, and at k = 16 the flushes take about half
//   of a warp's scan (tools/knn_brute_clocks.py counts both);
// - the k results come from k rounds of a group-wide minimum of the lists'
//   heads by (dist2, index) (__shfl_xor_sync), the lane holding the winner
//   popping it: the k least (dist2, index) pairs, whatever the order of
//   the visits, so the lower index wins an exact tie, as it did in the
//   one-thread-a-query kernel this one replaces.
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

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// the brute-force kernel

constexpr int kBruteThreads = 256;  // a block: kBruteThreads / G queries
constexpr int kBruteWarps = kBruteThreads / 32;
constexpr int kLaneWarps = 4;       // warps an SM the lane rule aims at
constexpr int kCompactRefs = 4;     // consecutive refs a thread compacts a pass
constexpr int kUnroll = 4;          // distances a lane forms before their gates
constexpr int kQueue = 8;           // queued candidates a thread (shared memory)
constexpr int kDirectRefs = 12288;  // sets up to this many refs are staged whole
constexpr int kTileRefs = 4096;     // larger ones stream through in tiles
constexpr int kPadRefs = kUnroll * 32;  // room for the sentinels of a last step
constexpr size_t kQueueSmem = (size_t)kQueue * kBruteThreads * sizeof(float2);
constexpr size_t kDirectSmem = kQueueSmem + (size_t)(kDirectRefs + kPadRefs) * sizeof(float4);
constexpr size_t kTiledSmem = kQueueSmem + (size_t)(kTileRefs + kPadRefs) * sizeof(float4) +
                              (size_t)kTileRefs * 2 * 3 * sizeof(float);

// Appends the valid refs of [t0, t1) to stage[n..] in index order, as (x,
// y, z, index as int bits); ``xyz`` starts at ref t0's coordinates (device
// or shared memory), ``mask`` is the sample's.  A pass takes kCompactRefs
// consecutive refs a thread, a warp scan of their counts and a block scan
// of the warps' totals; ``sums`` (2 x kBruteWarps) alternates between
// passes, so one barrier a pass.  Returns the new count to every thread;
// the caller synchronises before reading ``stage``.
__device__ __forceinline__ int compact_refs(const float* xyz, const uint8_t* __restrict__ mask,
                            int t0, int t1, float4* stage, int n, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* part = sums;
  for (int c0 = t0; c0 < t1; c0 += kBruteThreads * kCompactRefs) {
    const int j0 = c0 + threadIdx.x * kCompactRefs;
    bool valid[kCompactRefs];
    float p[kCompactRefs][3];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kCompactRefs; ++u) {
      const int j = j0 + u;
      valid[u] = j < t1 && mask[j];
      if (valid[u]) {
        const float* s = xyz + (size_t)(j - t0) * 3;
        p[u][0] = s[0];
        p[u][1] = s[1];
        p[u][2] = s[2];
      }
      cnt += valid[u];
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) part[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kBruteWarps; ++w) {
      const int s = part[w];
      before += w < warp ? s : 0;
      total += s;
    }
    int pos = n + before + incl - cnt;
#pragma unroll
    for (int u = 0; u < kCompactRefs; ++u) {
      if (valid[u]) stage[pos++] = make_float4(p[u][0], p[u][1], p[u][2], __int_as_float(j0 + u));
    }
    n += total;
    part = part == sums ? sums + kBruteWarps : sums;
  }
  return n;
}

// A list entry: (dist2, index) as one 64-bit key, the distance's bits
// above the index's.  A distance is +0, positive or +inf, and such floats'
// bits order as their values do, so keys order as (dist2, index) pairs:
// one 64-bit compare keeps the lower index first on an exact tie.  An
// empty slot is (+inf, -1), after every candidate.
using Key = unsigned long long;
constexpr Key kEmptyKey = 0x7f800000ffffffffull;

__device__ __forceinline__ Key make_key(float d, int j) {
  return ((Key)__float_as_uint(d) << 32) | (unsigned)j;
}

__device__ __forceinline__ float key_dist(Key key) {
  return __uint_as_float((uint32_t)(key >> 32));
}

__device__ __forceinline__ int key_index(Key key) { return (int)(uint32_t)key; }

// the candidate (d, j) into the lane's sorted list, when it comes before
// the list's last entry and is not farther than the group's gate ``tau``:
// slot s takes slot s-1's entry where the candidate comes before both, the
// candidate where it comes before s only
template <int K_MAX>
__device__ __forceinline__ void insert(float d, int j, float tau, Key (&key)[K_MAX]) {
  const Key c = make_key(d, j);
  if (d > tau || !(c < key[K_MAX - 1])) return;
#pragma unroll
  for (int s = K_MAX - 1; s > 0; --s) key[s] = c < key[s - 1] ? key[s - 1] : min(c, key[s]);
  key[0] = min(c, key[0]);
}

// the group's gate, after its lists changed: with m = min(k, ceil(2k / G))
// and r = ceil(k / m) (r <= G), the r-th least over the group's lanes of
// each lane's m-th distance (a bitonic sort across the group).  r lanes
// hold m refs each at or below it, r * m >= k refs in all, so a ref
// farther than it cannot be among the k nearest.
template <int K_MAX>
__device__ __forceinline__ float group_gate(const Key (&key)[K_MAX], int m, int r,
                                            int G, int l) {
  // the m-th distance as the least at slots m-1 on (the list is sorted): a
  // chain of selects of one slot would be compiled into an indexed load,
  // and that moves the whole list out of registers into local memory
  float v = INFINITY;
#pragma unroll
  for (int s = 0; s < K_MAX; ++s) v = fminf(v, s >= m - 1 ? key_dist(key[s]) : INFINITY);
  for (int size = 2; size <= G; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, stride);
      v = ((l & stride) == 0) == ((l & size) == 0) ? fminf(v, o) : fmaxf(v, o);
    }
  }
  return __shfl_sync(kFull, v, (threadIdx.x & 31) - l + r - 1);
}

// the least float above a distance (+inf stays): d <= x is d < next_up(x)
__device__ __forceinline__ float next_up(float tau) {
  return tau < INFINITY ? __int_as_float(__float_as_int(tau) + 1) : INFINITY;
}

// the queued candidates of this thread into its list, in the order they came
template <int K_MAX>
__device__ __forceinline__ void flush(const float2* queue, int& qn, float tau,
                                      Key (&key)[K_MAX]) {
  float2 e = queue[0];
  for (int t = 0; t < qn; ++t) {
    // the next entry in flight during this insert
    const float2 next = queue[min(t + 1, kQueue - 1) * kBruteThreads];
    insert<K_MAX>(e.x, __float_as_int(e.y), tau, key);
    e = next;
  }
  qn = 0;
}

// the step a warp visits second, third, ...: a stride P coprime with the
// step count (so every step comes once) near its golden section, which
// sends consecutive visits far apart along the refs' order
__device__ __forceinline__ int visit_stride(int steps) {
  int p = max(1, (int)(0.618034f * (float)steps));
  for (;; --p) {
    int a = steps, b = p;
    while (b != 0) {
      const int c = a % b;
      a = b;
      b = c;
    }
    if (a == 1) return p;
  }
}

// lane l's scan of the staged refs j = l (mod G), padded with far
// sentinels to whole steps of kUnroll * G refs.  The warp visits the steps
// from ``home`` on in strides of visit_stride: refs that come in spatial
// order (the z-order of a sampled set) would otherwise draw near a query
// step by step, each nearer ref an insertion; the home step, where the
// warp's first query sits in the same order, fills the lists with near
// refs first.  A candidate not after the lane's last entry and not farther
// than the group's gate goes to the thread's queue in shared memory (slot
// t at queue[t * kBruteThreads]); the warp inserts its queues when one of
// them might overflow, so an insertion costs the warp once for all its
// lanes instead of once a lane, and then renews the group's gate.  The
// step count is the same for every lane of the block, so the warp's votes
// and the group's shuffles are converged.
template <int K_MAX>
__device__ __forceinline__ void scan_refs(const float4* stage, int n, int l, int G, int m,
                                          int r, int home_q, int M, float qx, float qy,
                                          float qz, Key (&key)[K_MAX], float& tau,
                                          float2* queue, int& qn) {
  static_assert(kUnroll == 4, "the step's least distance below takes four");
  const int stride = kUnroll * G;
  const int steps = (n + stride - 1) / stride;
  if (steps == 0) return;
  const int span = steps * stride, hop = visit_stride(steps) * stride;
  const float4* lane_refs = stage + l;
  int at = min(steps - 1, (int)((long long)home_q * steps / M)) * stride;
  float gate = next_up(fminf(key_dist(key[K_MAX - 1]), tau));
  // software pipelined: the next step's refs are loaded before this step's
  // distances, so their latency is not on the loop's critical path (the
  // loads past the last step wrap round to a visited one, never out)
  float4 next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) next[u] = lane_refs[at + u * G];
  for (int s = 0; s < steps; ++s) {
    float4 e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) e[u] = next[u];
    at = at + hop < span ? at + hop : at + hop - span;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) next[u] = lane_refs[at + u * G];
    float d[kUnroll];
    int id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      d[u] = pcpdf::dist2(e[u].x, e[u].y, e[u].z, qx, qy, qz);
      id[u] = __float_as_int(e[u].w);
    }
    const float least = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
    if (!__any_sync(kFull, least < gate)) continue;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (d[u] < gate) {
        queue[qn * kBruteThreads] = make_float2(d[u], __int_as_float(id[u]));
        ++qn;
      }
    }
    if (__any_sync(kFull, qn > kQueue - kUnroll)) {
      flush<K_MAX>(queue, qn, tau, key);
      tau = group_gate<K_MAX>(key, m, r, G, l);
      gate = next_up(fminf(key_dist(key[K_MAX - 1]), tau));
    }
  }
}

// far sentinels (never nearer than any gate) from stage[n] up to whole steps
__device__ __forceinline__ void pad_refs(float4* stage, int n, int G) {
  const int end = (n + kUnroll * G - 1) / (kUnroll * G) * (kUnroll * G);
  for (int j = n + threadIdx.x; j < end; j += kBruteThreads)
    stage[j] = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
}

// (minimum blocks 1: without it ptxas held K_MAX = 4 to 80 registers and
// spilled; with it no instantiation spills, and shared memory allows two
// blocks an SM at the main path's sets either way)
template <int K_MAX>
__global__ void __launch_bounds__(kBruteThreads, 1)
knn_brute_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                 const uint8_t* __restrict__ ref_mask, int M, int N, int k, int G,
                 int* __restrict__ idx_out, float* __restrict__ dist_out) {
  extern __shared__ float4 smem[];
  __shared__ int sums[2 * kBruteWarps];
  const int b = blockIdx.y;
  const int l = threadIdx.x & (G - 1);
  const int q = blockIdx.x * (kBruteThreads / G) + threadIdx.x / G;
  const bool active = q < M;  // the others scan (the group's shuffles) but write nothing
  const float* qp = query + ((size_t)b * M + (active ? q : M - 1)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const int m = min(k, (2 * k + G - 1) / G), r = (k + m - 1) / m;  // group_gate
  // the warp's first query: its place among the queries is the warp's home
  // among the refs' steps (scan_refs)
  const int home_q = blockIdx.x * (kBruteThreads / G) + (threadIdx.x & ~31) / G;

  Key key[K_MAX];
#pragma unroll
  for (int s = 0; s < K_MAX; ++s) key[s] = kEmptyKey;
  float tau = INFINITY;
  // dynamic shared memory: the threads' queues, then the staged refs
  float2* queue = reinterpret_cast<float2*>(smem) + threadIdx.x;
  float4* stage = smem + kQueueSmem / sizeof(float4);
  int qn = 0;
  const float* rb = ref + (size_t)b * N * 3;
  const uint8_t* mb = ref_mask + (size_t)b * N;
  if (N <= kDirectRefs) {
    const int n = compact_refs(rb, mb, 0, N, stage, 0, sums);
    pad_refs(stage, n, G);
    __syncthreads();
    scan_refs<K_MAX>(stage, n, l, G, m, r, home_q, M, qx, qy, qz, key, tau, queue, qn);
  } else {
    // tiles of kTileRefs: tile t + 1's coordinates come in (cp.async, two
    // buffers after the staged float4s) while tile t is compacted and scanned
    float* raw = reinterpret_cast<float*>(stage + kTileRefs + kPadRefs);
    const int tiles = (N + kTileRefs - 1) / kTileRefs;
    auto fetch = [&](int t) {
      const int t0 = t * kTileRefs, len = 3 * (min(N, t0 + kTileRefs) - t0);
      float* dst = raw + (t & 1) * 3 * kTileRefs;
      for (int e = threadIdx.x; e < len; e += kBruteThreads)
        pcpdf::cp_async4(reinterpret_cast<int*>(dst + e),
                         reinterpret_cast<const int*>(rb + (size_t)t0 * 3 + e));
      pcpdf::cp_async_commit();
    };
    fetch(0);
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) {
        fetch(t + 1);
        pcpdf::cp_async_wait<1>();
      } else {
        pcpdf::cp_async_wait<0>();
      }
      __syncthreads();
      const int t0 = t * kTileRefs;
      const int n = compact_refs(raw + (t & 1) * 3 * kTileRefs, mb, t0,
                                 min(N, t0 + kTileRefs), stage, 0, sums);
      pad_refs(stage, n, G);
      __syncthreads();
      scan_refs<K_MAX>(stage, n, l, G, m, r, home_q, M, qx, qy, qz, key, tau, queue, qn);
      __syncthreads();  // the staged refs and this tile's buffer are free again
    }
  }
  flush<K_MAX>(queue, qn, tau, key);

  // slots past the valid refs hold +inf and repeat the nearest index (or 0
  // when there is none), so every index is a safe gather row
  int* io = idx_out + ((size_t)b * M + q) * k;
  float* dout = dist_out + ((size_t)b * M + q) * k;
  if (G == 1) {
    if (!active) return;
    const int first = key_index(key[0]) >= 0 ? key_index(key[0]) : 0;
#pragma unroll
    for (int s = 0; s < K_MAX; ++s) {
      if (s < k) {
        io[s] = key_index(key[s]) >= 0 ? key_index(key[s]) : first;
        dout[s] = key_dist(key[s]);
      }
    }
    return;
  }
  // k rounds of the group's least head; real entries have distinct
  // indices, so one lane holds the winner and pops it
  int first = 0;
  for (int round = 0; round < k; ++round) {
    Key least = key[0];
    for (int off = 1; off < G; off <<= 1) least = min(least, __shfl_xor_sync(kFull, least, off));
    const bool found = key_dist(least) < INFINITY;
    if (round == 0 && found) first = key_index(least);
    if (active && l == (round & (G - 1))) {
      io[round] = found ? key_index(least) : first;
      dout[round] = key_dist(least);
    }
    if (found && key[0] == least) {
#pragma unroll
      for (int s = 0; s < K_MAX - 1; ++s) key[s] = key[s + 1];
      key[K_MAX - 1] = kEmptyKey;
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    count = count > 0 ? count : 132;
  }
  return count;
}

// the lanes a query: the fewest (a power of two, 1 to 32) that give the
// grid kLaneWarps warps for every SM
int brute_lanes(int B, int M) {
  const long long want = (long long)sm_count() * kLaneWarps * 32;
  int G = 1;
  while (G < 32 && (long long)B * M * G < want) G <<= 1;
  return G;
}

template <int K_MAX>
cudaError_t launch_brute(const float* query, const float* ref, const uint8_t* mask,
                         int B, int M, int N, int k, int G, int* idx, float* dist,
                         cudaStream_t stream) {
  static bool large_smem = false;  // once an instantiation
  if (!large_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_brute_kernel<K_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kDirectSmem > kTiledSmem ? kDirectSmem : kTiledSmem));
    if (err != cudaSuccess) return err;
    large_smem = true;
  }
  const size_t smem = N <= kDirectRefs
                          ? kQueueSmem + (size_t)(N + kPadRefs) * sizeof(float4)
                          : kTiledSmem;
  const int queries = kBruteThreads / G;
  dim3 grid((M + queries - 1) / queries, B);
  knn_brute_kernel<K_MAX><<<grid, kBruteThreads, smem, stream>>>(query, ref, mask, M, N,
                                                                 k, G, idx, dist);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the bound-pruned kernel and its prep

constexpr int kPrepThreads = 256;
constexpr int kBoxParts = 32;    // blocks a sample in the bounding-box pass
constexpr int kMaxChunk = 256;   // largest chunk of sorted refs (R)
constexpr int kWarp = 32;        // a tile of sorted queries: one warp
constexpr int kPrunedWarps = 4;  // warps (tiles) a block of the pruned kernel
constexpr int kMortonMax = 1023;    // 10 bits an axis

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

// The brute-force search with G lanes a query (a power of two, 1 to 32;
// 0: the host's rule, pcpdf_knn_lanes): as pcpdf_knn.
extern "C" int pcpdf_knn_brute(const void* query, const void* ref, const void* ref_mask,
                               int B, int M, int N, int k, int lanes, void* idx,
                               void* dist2, void* stream) {
  if (k < 1 || k > 64 || k > N) return (int)cudaErrorInvalidValue;
  if (lanes < 0 || lanes > 32 || (lanes & (lanes - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return 0;
  const int G = lanes != 0 ? lanes : brute_lanes(B, M);
  auto q = static_cast<const float*>(query);
  auto r = static_cast<const float*>(ref);
  auto m = static_cast<const uint8_t*>(ref_mask);
  auto i = static_cast<int*>(idx);
  auto d = static_cast<float*>(dist2);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 4) return (int)launch_brute<4>(q, r, m, B, M, N, k, G, i, d, s);
  if (k <= 8) return (int)launch_brute<8>(q, r, m, B, M, N, k, G, i, d, s);
  if (k <= 16) return (int)launch_brute<16>(q, r, m, B, M, N, k, G, i, d, s);
  if (k <= 32) return (int)launch_brute<32>(q, r, m, B, M, N, k, G, i, d, s);
  return (int)launch_brute<64>(q, r, m, B, M, N, k, G, i, d, s);
}

// query (B, M, 3) f32, ref (B, N, 3) f32, ref_mask (B, N) u8, 1 <= k <= N,
// k <= 64 -> idx (B, M, k) i32, dist2 (B, M, k) f32, ascending.
extern "C" int pcpdf_knn(const void* query, const void* ref,
                         const void* ref_mask, int B, int M, int N, int k,
                         void* idx, void* dist2, void* stream) {
  return pcpdf_knn_brute(query, ref, ref_mask, B, M, N, k, 0, idx, dist2, stream);
}

// The lanes a query that pcpdf_knn takes for B samples of M queries.
extern "C" int pcpdf_knn_lanes(int B, int M) { return brute_lanes(B, M); }

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
