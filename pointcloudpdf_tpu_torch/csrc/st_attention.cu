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
// Bound on the card: by the count, operations (~15 C flop a valid pair
// against ~16 C bytes a query); what a kernel waits for is the gathers.
// Reading the tables by bin for every pair, as one warp a query over all
// C channels must (the tables, 9 x 2L x C floats, do not fit a block),
// moved ~4 GB a call through L2 at layer 1.  Here the tables stay in
// shared memory and a pair reads only its k and v rows from L2:
//
// - A persistent block (16 warps) takes a head group of HG = 2 heads (every
//   supported C has an even number of heads) and walks tiles of TQ = 32
//   queries.  It stages its heads' slices of the three tables once
//   (cp.async; 3 x 2L x 16 floats a table and head, 36,864 bytes a head at
//   2L = 64): Tq swizzled for the q-term product's B fragments, Tv for the
//   value product's, Tk with the two heads' rows of a bin side by side (128
//   bytes: one pair's row of a bin is one shared-memory wavefront).
//   Splitting the heads over blocks also fills the grid where the queries
//   are few (1,024 points a sample).
// - A warp takes two queries of a tile: it compacts their valid slots
//   (ballots) and computes the three bins of each once for both heads, with
//   the plain version's f32 operations in its order and without FMA
//   contraction (a true division, not a multiplication by 1/quant), so
//   kernel and plain version pick the same bins.  It does so for the next
//   tile while the block finishes this one (two list buffers).
// - The query term as a product: QT = (s q_h) Tq_h^T, (TQ x 16) x (16 x
//   3 2L) a head, on the tensor cores; a pair then reads three scalars of
//   its query's rows of QT instead of three table rows.
// - Logits: two lanes a pair, a head each: the head's slice of the pair's
//   k row gathered from L2 (64 bytes; the pair's two lanes read its 128-byte
//   row), dotted with s q plus the sum of its three Tk rows from shared
//   memory, plus its three QT scalars.  A lane takes its four 16-byte
//   chunks in an order rotated by the pair, so a quarter-warp's reads of
//   four rows hit eight distinct chunks; s q of the lane's query and head
//   sits in registers in the same order; the next eight pairs' k rows load
//   while these compute.  All logits of a (query, head) are kept (K <= 64),
//   so the softmax takes the max, then exp and the sum: no rescale a key.
// - The value term as a histogram product: sum_j p_j sum_a Tv[a][bin_ja] =
//   sum_a sum_b (sum_{j: bin_ja = b} p_j) Tv[a][b].  The warp scatters its
//   queries' p into 3 x 2L histograms in fixed point of 2^-24 (integer
//   atomics in shared memory are native, float ones a compare-and-swap loop;
//   integer sums are exact in any order; in the rows QT held), and the block
//   takes (TQ x 3 2L) x (3 2L x 16) a head on the tensor cores.  sum_j p_j
//   v_j takes a lane a channel of the group, a pair's v row one coalesced
//   128-byte load of the warp.
// - Tensor-core products are mma.sync m16n8k8 in split TF32 (common.cuh:
//   each operand x = hi + lo, three products summed from 0 into an f32
//   accumulator), which keeps f32 accuracy where one-pass TF32 would not.
// Three barriers a tile (QT; logits, p and the next lists; the value
// product and the next s q).  Sums in f32; the inputs are f32.
//
// What bounds it now, measured on the card (tools/st_attention_clocks.py,
// layer 1 of the ST config: 2 x 16,384 queries, C = 96, K = 48): a tile
// takes ~33,000 cycles, of which the k and v gathers ~14,500 (the
// logits' and sum_j p_j v_j's steps, each at 4-6 TB/s from L2 across the
// card) and the rest the lists, the softmax, the histogram and the two
// products, which leave L2 idle: the gathers alone are ~0.19 ms a call.
// Variants measured no faster: a lane a pair over both heads, eight lanes
// a pair, one warp a query at 1,024 threads, the block as two halves of
// 16 queries under named barriers, the value term as three Tv rows a pair
// from shared memory in place of the histogram product, and the v gathers
// moved beside the value product.

#include "common.cuh"

namespace {

using pcpdf::cp_async16;
using pcpdf::cp_async_commit;
using pcpdf::cp_async_wait;
using pcpdf::mma_split;
using pcpdf::split_tf32;

constexpr int HG = 2;         // heads a block
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int TQ = 32;        // queries a tile: two m-tiles of the products
constexpr int kQW = TQ / kWarps;   // queries a warp
constexpr int kLanesQ = 32 / kQW;  // lanes a query: softmax and histogram
constexpr int kMaxSlots = 64; // K, at most: a query's logits stay in shared memory
constexpr int kMaxBins = 80;  // 2L, at most: the tables and QT fill shared memory
constexpr int QS = 20;        // row stride of s q: conflict-free A fragments
constexpr int QH = TQ * QS + 16;  // head stride of s q: a lane's chunks of both
                                  // heads on distinct banks
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFix = 16777216.f;  // 2^24: the histograms' fixed point
// a warp a (head, m-tile, quarter of the n-tiles) of the q-term product
// and a (head, m-tile, n-tile, half of the k-steps) of the value product
static_assert(kWarps == HG * 2 * 4 && kQW * kWarps == TQ && kQW == 2, "the warps' tasks");

// table rows a head: 3 x 2L, padded to mma's n / k of 8 (the padding rows
// are zeros)
__host__ __device__ constexpr int table_rows(int L2) { return (3 * L2 + 7) / 8 * 8; }

// offsets into shared memory, in 4-byte words
struct Layout {
  int tq, tk, tv, qt, q, l, o, vt, sum, row, bins, nv, total;
};

__host__ __device__ constexpr Layout layout(int R) {
  Layout s{};
  const int RS = R + 4;  // QT / histogram row stride: conflict-free A fragments
  s.tq = 0;                            // [HG][R][16], swizzled (tq_at)
  s.tk = s.tq + HG * R * 16;           // [R][HG][16]
  s.tv = s.tk + HG * R * 16;           // [HG][R][16], swizzled (tv_at)
  s.qt = s.tv + HG * R * 16;           // [HG][TQ][RS] QT, then the histogram
  s.q = s.qt + HG * TQ * RS;           // [HG][QH] s q, rows of QS
  s.l = s.q + HG * QH;                 // [HG][TQ][kMaxSlots] logits, then p
  s.o = s.l + HG * TQ * kMaxSlots;     // [HG][TQ][16] sum_j p_j v_j
  s.vt = s.o + HG * TQ * 16;           // [2][HG][TQ][16] the value product by k half
  s.sum = s.vt + 2 * HG * TQ * 16;     // [HG][TQ] sum_j p_j
  s.row = s.sum + HG * TQ;             // [2][TQ][kMaxSlots] key rows of the valid slots
  s.bins = s.row + 2 * TQ * kMaxSlots; // [2][TQ][kMaxSlots] their bins, a byte an axis
  s.nv = s.bins + 2 * TQ * kMaxSlots;  // [2][TQ] valid slots
  s.total = s.nv + 2 * TQ;
  return s;
}

constexpr size_t kMaxSmem = 232448;  // a block's opt-in shared memory on sm_90
static_assert((size_t)layout(table_rows(kMaxBins)).total * 4 <= kMaxSmem,
              "the widest tables fit a block");

// where element (r, c) of a head's Tq or Tv slice (16 channels a row)
// lies: Tq with its 16-byte quads XOR-ed by row bits 1-2 (the q-term
// product reads B[k = c][n = r]: 8 rows x 4 channels a fragment), Tv with
// its 8-channel halves XOR-ed by row bit 1 (the value product reads B[k =
// r][n = c]: 4 rows x 8 channels)
__device__ __forceinline__ int tq_at(int r, int c) {
  return r * 16 + ((((c >> 2) ^ (r >> 1)) & 3) << 2) + (c & 3);
}
__device__ __forceinline__ int tv_at(int r, int c) { return r * 16 + (c ^ ((r & 2) << 2)); }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ const float4& lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads, 1)
st_attention_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                    const float* __restrict__ vp, const float* __restrict__ coord,
                    const int* __restrict__ key_idx,
                    const uint8_t* __restrict__ key_mask,
                    const float* __restrict__ tq, const float* __restrict__ tk,
                    const float* __restrict__ tv, float scale, float two_ws,
                    float eps, float quant, int B, int N, int C, int K, int L2,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int R = table_rows(L2), RS = R + 4;
  const Layout S = layout(R);
  float* sQT = smem + S.qt;
  int* sH = reinterpret_cast<int*>(sQT);  // the histograms, in QT's rows
  float* sQ = smem + S.q;
  float* sL = smem + S.l;
  float* sO = smem + S.o;
  float* sVT = smem + S.vt;
  float* sSum = smem + S.sum;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int M = B * N;
  const int hoff = blockIdx.y * HG * 16;      // the group's first channel
  const int qb = warp * kQW;                  // this warp's first query of a tile
  const float top = (float)(L2 - 1);
  const int tiles = (M + TQ - 1) / TQ;

  // the group's table slices, once a block
  for (int e = tid; e < 3 * HG * R * 4; e += kThreads) {
    const int i = e & 3, r = (e >> 2) % R, th = (e >> 2) / R, t = th / HG, h = th % HG;
    const float* src = t == 0 ? tq : t == 1 ? tk : tv;
    if (src == nullptr) continue;
    float* dst = t == 0   ? smem + S.tq + h * R * 16 + tq_at(r, 4 * i)
                 : t == 1 ? smem + S.tk + (r * HG + h) * 16 + 4 * i
                          : smem + S.tv + h * R * 16 + tv_at(r, 4 * i);
    if (r < 3 * L2)
      cp_async16(dst, src + (long long)r * C + hoff + h * 16 + 4 * i);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();

  // the valid slots of this warp's queries of a tile, their key rows and
  // bins, into list buffer ``buf`` (lane l: slots l and l + 32)
  auto build_lists = [&](int tile, int buf) {
    int* sRow = reinterpret_cast<int*>(smem + S.row) + buf * TQ * kMaxSlots;
    uint32_t* sBins = reinterpret_cast<uint32_t*>(smem + S.bins) + buf * TQ * kMaxSlots;
    int* sNv = reinterpret_cast<int*>(smem + S.nv) + buf * TQ;
    const int m0 = tile * TQ;
    float cq[kQW][3], kc[kQW][2][3];
    int kid[kQW][2], boff[kQW];
    bool on[kQW][2];
#pragma unroll
    for (int j = 0; j < kQW; ++j) {
      const int m = m0 + qb + j;
      const bool live = m < M;
      boff[j] = live ? (m / N) * N : 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) cq[j][a] = live ? coord[(long long)m * 3 + a] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = lane + 32 * r;
        const bool ok = live && s < K;
        on[j][r] = ok && key_mask[(long long)m * K + s] != 0;
        kid[j][r] = ok ? key_idx[(long long)m * K + s] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kQW; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int a = 0; a < 3; ++a)
          kc[j][r][a] = on[j][r] ? coord[(long long)(boff[j] + kid[j][r]) * 3 + a] : 0.f;
#pragma unroll
    for (int j = 0; j < kQW; ++j) {
      int pos = 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t pk = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float rel = __fsub_rn(cq[j][a], kc[j][r][a]);
          const float t = __fsub_rn(__fadd_rn(rel, two_ws), eps);
          const float bin = fminf(fmaxf(floorf(__fdiv_rn(t, quant)), 0.f), top);
          pk |= (uint32_t)bin << (8 * a);
        }
        const unsigned ballot = __ballot_sync(kFull, on[j][r]);
        if (on[j][r]) {
          const int at = (qb + j) * kMaxSlots + pos + __popc(ballot & ((1u << lane) - 1u));
          sRow[at] = boff[j] + kid[j][r];
          sBins[at] = pk;
        }
        pos += __popc(ballot);
      }
      if (lane == 0) sNv[qb + j] = pos;
    }
  };
  // s q of a tile's queries
  auto load_q = [&](int tile) {
    for (int e = tid; e < HG * TQ * 4; e += kThreads) {
      const int i = e & 3, qi = (e >> 2) % TQ, h = (e >> 2) / TQ, m = tile * TQ + qi;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        x = ldg4(qp + (long long)m * C + hoff + h * 16 + 4 * i);
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
      }
      *reinterpret_cast<float4*>(sQ + h * QH + qi * QS + 4 * i) = x;
    }
  };

  if (blockIdx.x < tiles) {
    build_lists(blockIdx.x, 0);
    load_q(blockIdx.x);
  }
  cp_async_wait<0>();  // the tables
  __syncthreads();

  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int m0 = tile * TQ, next = tile + gridDim.x;
    const int* sRow = reinterpret_cast<const int*>(smem + S.row) + buf * TQ * kMaxSlots;
    const uint32_t* sBins =
        reinterpret_cast<const uint32_t*>(smem + S.bins) + buf * TQ * kMaxSlots;
    const int* sNv = reinterpret_cast<const int*>(smem + S.nv) + buf * TQ;

    // --- QT[h][q][r] = s q . Tq[r], a warp a (head, m-tile, quarter of
    // the n-tiles)
    if (tq != nullptr) {
      const int h = warp >> 3, mt = (warp >> 2) & 1, nq = warp & 3;
      const float* Q = sQ + h * QH + 16 * mt * QS;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int c = 8 * ks + tig;
        const float a[4] = {Q[gid * QS + c], Q[(gid + 8) * QS + c], Q[gid * QS + c + 4],
                            Q[(gid + 8) * QS + c + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[ks][e], al[ks][e]);
      }
      const float* T = smem + S.tq + h * R * 16;
      float* D = sQT + (h * TQ + 16 * mt) * RS;
#pragma unroll 2
      for (int nt = nq; nt < R / 8; nt += 4) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const int r = 8 * nt + gid;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int c = 8 * ks + tig;
          uint32_t bh[2], bl[2];
          split_tf32(T[tq_at(r, c)], bh[0], bl[0]);
          split_tf32(T[tq_at(r, c + 4)], bh[1], bl[1]);
          mma_split(acc, ah[ks], al[ks], bh, bl);
        }
        *reinterpret_cast<float2*>(D + gid * RS + 8 * nt + 2 * tig) = make_float2(acc[0], acc[1]);
        *reinterpret_cast<float2*>(D + (gid + 8) * RS + 8 * nt + 2 * tig) =
            make_float2(acc[2], acc[3]);
      }
    }
    __syncthreads();

    // --- this warp's queries: logits, softmax, histogram, sum_j p_j v_j,
    // and the next tile's lists into the other buffer (its last reader was
    // the tile before this one): odd warps take the lists first, so that
    // half the warps wait on memory while the other half read shared memory
    if ((warp & 1) && next < tiles) build_lists(next, buf ^ 1);
    {
      // the valid slots of the warp's first query, and of both
      const int n0 = sNv[qb], total = n0 + sNv[qb + 1];
      // logits, two lanes a pair (a head each), sixteen lanes a query: the
      // head's slice of the pair's k row dotted with s q plus the three Tk
      // rows of its bins, four 16-byte chunks taken in an order rotated by
      // the pair, so that a quarter-warp's eight lanes read eight distinct
      // chunks of their 128-byte rows; s q of the lane's query and head held
      // in registers in the same order.  The next eight pairs' k rows load
      // while these compute.
      {
        const int q = qb + (lane >> 4), nq = sNv[q], hr = lane & 1, ps = (lane >> 1) & 7;
        float4 qr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) qr[u] = lds4(sQ + hr * QH + q * QS + 4 * ((u + ps) & 3));
        const float* Tk = smem + S.tk + hr * 16;
        struct Pair {
          float4 k[4];
          uint32_t pk;
          int at;
          bool live;
        };
        // a lane past its query's slots works on row 0, bins 0, unused
        auto fetch = [&](int i0, Pair& p) {
          const int i = i0 + ps;
          p.live = i < nq;
          p.at = q * kMaxSlots + i;
          p.pk = p.live ? sBins[p.at] : 0u;
          const float* krow = kp + (p.live ? (long long)sRow[p.at] * C : 0ll) + hoff + hr * 16;
#pragma unroll
          for (int u = 0; u < 4; ++u) p.k[u] = ldg4(krow + 4 * ((u + ps) & 3));
        };
        auto logit = [&](const Pair& p) {
          const int b0 = p.pk & 255, b1 = L2 + ((p.pk >> 8) & 255),
                    b2 = 2 * L2 + ((p.pk >> 16) & 255);
          float d = 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float4 t = qr[u];
            if (tk != nullptr) {
              const float* T = Tk + 4 * ((u + ps) & 3);
              const float4 t0 = lds4(T + b0 * HG * 16), t1 = lds4(T + b1 * HG * 16),
                           t2 = lds4(T + b2 * HG * 16);
              t = make_float4(t.x + (t0.x + t1.x + t2.x), t.y + (t0.y + t1.y + t2.y),
                              t.z + (t0.z + t1.z + t2.z), t.w + (t0.w + t1.w + t2.w));
            }
            d += p.k[u].x * t.x + p.k[u].y * t.y + p.k[u].z * t.z + p.k[u].w * t.w;
          }
          if (p.live) {
            if (tq != nullptr) {
              const float* Q = sQT + (hr * TQ + q) * RS;
              d += Q[b0] + Q[b1] + Q[b2];
            }
            sL[hr * TQ * kMaxSlots + p.at] = d;
          }
        };
        const int most = n0 > total - n0 ? n0 : total - n0;
        Pair a, b;
        if (most > 0) fetch(0, a);
        for (int i0 = 0; i0 < most; i0 += 16) {
          if (i0 + 8 < most) fetch(i0 + 8, b);
          logit(a);
          if (i0 + 8 < most) {
            if (i0 + 16 < most) fetch(i0 + 16, a);
            logit(b);
          }
        }
      }
      __syncwarp();
      // the softmax of each (query, head) over its valid slots, kLanesQ
      // lanes a query: sL takes p = exp(logit - max), sSum their sum
      const int jq = lane / kLanesQ, sq = lane % kLanesQ, q = qb + jq;
      const int n = sNv[q];
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        float* Lh = sL + (h * TQ + q) * kMaxSlots;
        float mx = -INFINITY;
        for (int i = sq; i < n; i += kLanesQ) mx = fmaxf(mx, Lh[i]);
#pragma unroll
        for (int o = 1; o < kLanesQ; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        float sum = 0.f;
        for (int i = sq; i < n; i += kLanesQ) {
          const float e = expf(Lh[i] - mx);
          Lh[i] = e;
          sum += e;
        }
#pragma unroll
        for (int o = 1; o < kLanesQ; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
        if (sq == 0) sSum[h * TQ + q] = sum;
      }
      if (tv != nullptr) {
        // the histograms of p by bin, p <= 1 in fixed point of 2^-24 (an
        // entry holds at most K 2^24 < 2^31), in the warp's rows of QT (read
        // above by this warp alone); a round of atomics spread over both
        // queries
#pragma unroll
        for (int h = 0; h < HG; ++h)
#pragma unroll
          for (int j = 0; j < kQW; ++j)
            for (int c = lane; c < R; c += 32) sH[(h * TQ + qb + j) * RS + c] = 0;
        __syncwarp();
        for (int i = sq; i < n; i += kLanesQ) {
          const uint32_t pk = sBins[q * kMaxSlots + i];
#pragma unroll
          for (int h = 0; h < HG; ++h) {
            int* Hq = sH + (h * TQ + q) * RS;
            const int p = __float2int_rn(sL[(h * TQ + q) * kMaxSlots + i] * kFix);
            atomicAdd(Hq + (pk & 255), p);
            atomicAdd(Hq + L2 + ((pk >> 8) & 255), p);
            atomicAdd(Hq + 2 * L2 + ((pk >> 16) & 255), p);
          }
        }
      }
      __syncwarp();
      // sum_j p_j v_j, a lane a channel of the group (head lane >> 4): the
      // warp reads each pair's v row in one 128-byte load
#pragma unroll 1
      for (int j = 0; j < kQW; ++j) {
        const int qj = qb + j, nj = sNv[qj];
        const int* rows = sRow + qj * kMaxSlots;
        const float* P = sL + ((lane >> 4) * TQ + qj) * kMaxSlots;
        const float* vg = vp + hoff + lane;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        int i = 0;
        for (; i + 4 <= nj; i += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u] += P[i + u] * __ldg(vg + (long long)rows[i + u] * C);
        }
        for (; i < nj; ++i) acc[0] += P[i] * __ldg(vg + (long long)rows[i] * C);
        sO[((lane >> 4) * TQ + qj) * 16 + (lane & 15)] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
    if (!(warp & 1) && next < tiles) build_lists(next, buf ^ 1);
    __syncthreads();

    // --- the next tile's s q (QT, this tile's last reader, is done), then
    // the value product: histogram (TQ x R) x Tv (R x 16) a head, a warp a
    // (head, m-tile, n-tile, half of the k-steps)
    if (next < tiles) load_q(next);
    if (tv != nullptr) {
      const int h = warp >> 3, mt = (warp >> 2) & 1, nt = (warp >> 1) & 1, kh = warp & 1;
      const int* A = sH + (h * TQ + 16 * mt) * RS;
      const float* T = smem + S.tv + h * R * 16;
      const int steps = R / 8, half = (steps + 1) / 2;
      const int k0 = kh * half, k1 = min(steps, k0 + half);
      const int col = 8 * nt + gid;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int ks = k0; ks < k1; ++ks) {
        const int c = 8 * ks + tig;
        const int a[4] = {A[gid * RS + c], A[(gid + 8) * RS + c], A[gid * RS + c + 4],
                          A[(gid + 8) * RS + c + 4]};
        uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__int2float_rn(a[e]) * (1.f / kFix), ah[e], al[e]);
        split_tf32(T[tv_at(c, col)], bh[0], bl[0]);
        split_tf32(T[tv_at(c + 4, col)], bh[1], bl[1]);
        mma_split(acc, ah, al, bh, bl);
      }
      float* D = sVT + ((kh * HG + h) * TQ + 16 * mt) * 16 + 8 * nt + 2 * tig;
      *reinterpret_cast<float2*>(D + gid * 16) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(D + (gid + 8) * 16) = make_float2(acc[2], acc[3]);
    }
    __syncthreads();

    // --- out = (sum_j p_j v_j + the value product) / sum_j p_j; the next
    // tile's QT may start beside it (it touches none of these)
    for (int e = tid; e < HG * TQ * 4; e += kThreads) {
      const int i = e & 3, qi = (e >> 2) % TQ, h = (e >> 2) / TQ, m = m0 + qi;
      if (m >= M) continue;
      float4 o = lds4(sO + (h * TQ + qi) * 16 + 4 * i);
      if (tv != nullptr) {
        const float4 v0 = lds4(sVT + (h * TQ + qi) * 16 + 4 * i);
        const float4 v1 = lds4(sVT + ((HG + h) * TQ + qi) * 16 + 4 * i);
        o = make_float4(o.x + v0.x + v1.x, o.y + v0.y + v1.y, o.z + v0.z + v1.z,
                        o.w + v0.w + v1.w);
      }
      const float s = sSum[h * TQ + qi];
      const float4 r = s > 0.f ? make_float4(o.x / s, o.y / s, o.z / s, o.w / s)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(out + (long long)m * C + hoff + h * 16 + 4 * i) = r;
    }
  }
}

}  // namespace

// q/k/v (B, N, C) f32, coord (B, N, 3) f32, key_idx (B, N, K) i32 rows of
// the same sample, key_mask (B, N, K) u8, tq/tk/tv (3, L2, C) f32 or null
// -> out (B, N, C) f32.  Head width 16; C in {32, 64, 96, 128, 192, 256,
// 384, 512}; K <= 64; L2 <= 80.
extern "C" int pcpdf_st_attention(
    const void* q, const void* k, const void* v, const void* coord,
    const void* key_idx, const void* key_mask, const void* tq, const void* tk,
    const void* tv, float scale, float two_ws, float eps, float quant, int B,
    int N, int C, int K, int L2, void* out, void* stream) {
  const long long M = (long long)B * N;
  if (M == 0) return 0;
  const bool width = C == 32 || C == 64 || C == 96 || C == 128 || C == 192 ||
                     C == 256 || C == 384 || C == 512;
  if (!width || K < 0 || K > kMaxSlots || L2 < 1 || L2 > kMaxBins || M >= (1ll << 31) - TQ)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)layout(table_rows(L2)).total * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      st_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, st_attention_kernel, kThreads,
                                                        bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // persistent blocks: a head group on blockIdx.y, its tiles strided over
  // blockIdx.x, one wave over the card
  const int groups = C / (16 * HG);
  const long long tiles = (M + TQ - 1) / TQ;
  long long across = (long long)per_sm * sms / groups;
  across = across < 1 ? 1 : across > tiles ? tiles : across;
  st_attention_kernel<<<dim3((unsigned)across, groups), kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(coord),
      static_cast<const int*>(key_idx), static_cast<const uint8_t*>(key_mask),
      static_cast<const float*>(tq), static_cast<const float*>(tk),
      static_cast<const float*>(tv), scale, two_ws, eps, quant, B, N, C, K, L2,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
