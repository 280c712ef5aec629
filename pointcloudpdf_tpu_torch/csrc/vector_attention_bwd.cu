// K4: PT-v1 vector attention, backward of the training forward.
//
// Replaces the TPU kernel _attn_bwd_kernel (called from
// _attention_core_bwd, pointcloudpdf_tpu/ops/pallas_attention.py).  The
// forward is vector_attention.cu with the affines (s, t) folded from the
// batch's masked statistics; it saves its inputs only.  Given dout
// (B, N, C), this kernel recomputes the chain and emits
//   d x_q  (B, N, C)  direct store, -sum_j dr
//   d x_k, d x_v      16-byte vector atomics at the gathered row j into
//                     zeroed buffers (the TPU version returned a
//                     payload-shaped cotangent and left the scatter to
//                     XLA's gather transpose; with the gather inside the
//                     kernel the scatter is here too)
//   d params          the cotangents of the four (W, b) pairs and the six
//                     affine vectors, in the layout of the packed parameter
//                     buffer (attn_layout)
// Masked neighbour slots add nothing to any output; a query with none gets
// d x_q = 0.  coord gets no cotangent (it is input data in every caller).
//
// Bound on the card.  Per valid pair the function moves ~16*C bytes
// (gathers of x_k and x_v rows, scatters of d x_k and d x_v) and does three
// C x G products (the recompute u = h2 W_w1, dh2 = du W_w1^T and d W_w1 +=
// h2^T du), 6*C*G flop, against ~16*C flop of everything else.  At C >= 256
// the products bound it on the CUDA cores, so they run on the tensor cores;
// at C <= 64 the gathers, the scatters and each tile's fixed steps take
// most of the time.
//
// Design, after the TPU kernel's own structure: a persistent block (256
// threads) takes tiles of TQ = P / K whole queries x K slots, P = 64 pair
// rows (32 at C = 512), and writes each step as a product over the tile:
//   pass A, C in chunks of 64: r = x_k[j] - x_q + p_r of the chunk into
//     shared memory, dw += the group sums of dout (x_v + p_r), and
//     U += relu(r s1 + t1) W_w1 (P x 64 . 64 x G);
//   then logits = h3 W_w2, the masked softmax of each query and its backward
//     close inside the tile (no second sweep over the neighbours, no
//     per-neighbour state in local memory), d W_w2 += h3^T ds,
//     dh3 = ds W_w2^T, du;
//   pass B, chunk by chunk: dh2 = du W_w1^T (P x G . G x 64), d W_w1 +=
//     h2^T du (64 x P . P x G), then dr, the d x_k / d x_v atomics, d x_q as
//     a sum over each query's rows, and the positional MLP's backward.
// Products: mma.sync m16n8k8 in split TF32.  Each f32 operand is x = hi +
// lo, hi = x rounded to TF32, lo = x - hi rounded to TF32; each k-step's
// a_lo b_hi + a_hi b_lo + a_hi b_hi, summed by the tensor core from 0 and
// added to an f32 sum on the CUDA cores, keeps f32 accuracy (one-pass TF32,
// a 10-bit mantissa, misses the 1e-4 tolerance of the check against the
// plain f32 version on a single product).  A warp takes WM x WN tiles of a product, so each split
// fragment serves several mma.  G = 4 (C = 32) is padded to the mma's n = 8
// with zero columns.  Everything else is f32 on the CUDA cores; the ReLU
// gates of both passes use one expression (fmaf, one rounding), so the
// passes agree on every gate.
// Latency: the elementwise phases give each lane 4 consecutive channels of
// a row and issue two steps' gathers before using either; at C <= 256 two blocks
// share an SM (128 registers, the per-channel partials kept in the r
// buffer), at C = 512 one (its accumulator alone is 160 KB).
// Parameter cotangents, no atomics in the pair loop: every element of the
// block's accumulator in shared memory is written in a phase by one thread
// (an mma fragment, or a column owner: per-channel sums are reduced over a
// warp's rows in registers, then over the 8 warps; per-group sums stay in
// registers over the launch); the block ends with ONE atomicAdd per element
// into the zeroed global buffer.  At C = 512 W_w1 (128 KB) stays in device
// memory beside that accumulator and is read through L1/L2, one 64-channel
// chunk per product and tile.
// Atomics make d x_k, d x_v and d params differ in the last bits from run
// to run.

#include "vector_attention.cuh"

namespace {

constexpr int kMaxK = 16;

using Layout = pcpdf::AttnLayout;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the shape of one width's tile and its shared memory, in floats
template <int C>
struct Tile {
  static constexpr int G = C / 8;
  // pair rows a tile: more at the narrow widths, where each tile's fixed
  // steps (its kNN rows, the gathers' latency, the syncs) dominate
  static constexpr int P = C >= 512 ? 32 : C >= 128 ? 64 : 128;
  static constexpr int GP = G < 8 ? 8 : G;      // groups, padded to mma's n
  static constexpr int CC = C < 64 ? C : 64;    // channels a chunk
  static constexpr int GS = GP + 4;             // row strides: conflict-free
  static constexpr int CS = CC + 4;             //   mma fragment reads
  static constexpr Layout L = pcpdf::attn_layout(C, G);
  static constexpr int kAcc = (L.total + 3) / 4 * 4;  // parameter cotangents
  static constexpr int kR = P * CS;                   // r of a chunk
  static constexpr int kU = P * (GS > CS ? GS : CS);  // u; dh2 in pass B
  static constexpr int kH = P * GS;                   // h3; then du
  static constexpr int kW = P * GS;                   // logits; then w
  static constexpr int kPart = kWarps * 6 * CC;  // per-channel partials
  // ... kept in the r buffer where they fit (then two blocks of C = 256
  // share an SM), else beside ds
  static constexpr bool kPartInR = kPart <= kR;
  static constexpr int kD = kPartInR || P * GS > kPart ? P * GS : kPart;
  static constexpr int kRow = P * 12;  // p_rel, z1, pre1, h of each row
  static constexpr int kDh1 = P * 4;   // d h of the positional MLP
  static constexpr int kFloats =
      kAcc + kR + kU + kH + kW + kD + kRow + kDh1 + 2 * C;
  static constexpr size_t kBytes = (size_t)(kFloats + 2 * P) * 4;
  // two blocks an SM where their shared memory fits (C <= 256): at most
  // 128 registers a thread
  static constexpr int kMinBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
  static_assert(kBytes <= 232448, "shared memory of one block");
  static_assert(C % CC == 0 && CC % 32 == 0 && GP % 8 == 0, "widths of the tile");
};

using pcpdf::attn_pos_hidden;
using pcpdf::attn_pr;
using pcpdf::mma_tf32;
using pcpdf::split_tf32;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// p[0..3] += v, as one 16-byte vector reduction (sm_90)
__device__ __forceinline__ void red4(float* p, const float (&v)[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// How the warps share a product's MT x NT tiles of 16 x 8: a grid of kRows x
// kCols warps, each taking WM x WN tiles; with WN = 2 (where the tiles are
// enough for 8 warps) each A fragment, the dearer operand to split, serves
// two tiles, and each B fragment serves WM.
template <int MT, int NT>
struct WarpTiles {
  static constexpr int WN = NT % 2 == 0 && MT * NT >= 2 * kWarps ? 2 : 1;
  static constexpr int kCols = NT / WN;
  static constexpr int kRows = kWarps / kCols < MT ? kWarps / kCols : MT;
  static constexpr int WM = MT / kRows;
  static constexpr int kTiles = WM * WN;
  static_assert(kWarps % kCols == 0 && MT % kRows == 0, "a grid of warps");
};

// acc += A (16 MT x 8 KT) . B (8 KT x 8 NT) in split TF32 over the warp's
// tiles (WarpTiles): each k-step's a_lo b_hi + a_hi b_lo + a_hi b_hi is
// summed by the tensor core from 0 and added to acc on the CUDA cores,
// rounded to nearest (the tensor core's own f32 sums round towards 0, a
// bias that would grow with the steps accumulated in one register).
// load_a(row, k) and load_b(k, col) give the operands' elements.  Fragment
// i WN + j holds the tile (m, n) = (wm WM + i, wn WN + j) and in element e
// its (row, col) = (16 m + gid + 8 (e >> 1), 8 n + 2 tig + (e & 1)),
// gid = lane / 4, tig = lane % 4.
template <int MT, int NT, int KT, class LoadA, class LoadB>
__device__ __forceinline__ void warp_mma(
    float (&acc)[WarpTiles<MT, NT>::kTiles][4], int warp, int lane,
    LoadA load_a, LoadB load_b) {
  using W = WarpTiles<MT, NT>;
  if (warp >= W::kCols * W::kRows) return;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 16 * W::WM * (warp / W::kCols), n0 = 8 * W::WN * (warp % W::kCols);
#pragma unroll 2  // (fully unrolled, the k-steps' loads exceed 128 registers)
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t bh[W::WN][2], bl[W::WN][2];
#pragma unroll
    for (int j = 0; j < W::WN; ++j) {
      split_tf32(load_b(8 * kk + tig, n0 + 8 * j + gid), bh[j][0], bl[j][0]);
      split_tf32(load_b(8 * kk + tig + 4, n0 + 8 * j + gid), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < W::WM; ++i) {
      const int row = m0 + 16 * i + gid;
      uint32_t ah[4], al[4];
      split_tf32(load_a(row, 8 * kk + tig), ah[0], al[0]);
      split_tf32(load_a(row + 8, 8 * kk + tig), ah[1], al[1]);
      split_tf32(load_a(row, 8 * kk + tig + 4), ah[2], al[2]);
      split_tf32(load_a(row + 8, 8 * kk + tig + 4), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < W::WN; ++j) {
        const float kZero[4] = {0.f, 0.f, 0.f, 0.f};
        float t[4];
        mma_tf32(t, al, bh[j], kZero);
        mma_tf32(t, ah, bl[j], t);
        mma_tf32(t, ah, bh[j], t);
        float* a = acc[i * W::WN + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] += t[e];
      }
    }
  }
}

// visit every element of the warp's fragments: fn(i, e, row, col)
template <int MT, int NT, class Fn>
__device__ __forceinline__ void for_fragments(int warp, int lane, Fn fn) {
  using W = WarpTiles<MT, NT>;
  if (warp >= W::kCols * W::kRows) return;
  const int m0 = 16 * W::WM * (warp / W::kCols), n0 = 8 * W::WN * (warp % W::kCols);
#pragma unroll
  for (int i = 0; i < W::WM; ++i)
#pragma unroll
    for (int j = 0; j < W::WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(i * W::WN + j, e, m0 + 16 * i + (lane >> 2) + 8 * (e >> 1),
           n0 + 8 * j + 2 * (lane & 3) + (e & 1));
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[WarpTiles<MT, NT>::kTiles][4]) {
#pragma unroll
  for (int i = 0; i < WarpTiles<MT, NT>::kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

template <int C>
__global__ void __launch_bounds__(kThreads, Tile<C>::kMinBlocks)
attn_bwd_kernel(const float* __restrict__ xq, const float* __restrict__ xk,
                const float* __restrict__ xv, const float* __restrict__ coord,
                const int* __restrict__ idx, const uint8_t* __restrict__ nmask,
                const float* __restrict__ params,
                const float* __restrict__ dout, int B, int N, int K, int TQ,
                float* __restrict__ dxq, float* __restrict__ dxk,
                float* __restrict__ dxv, float* __restrict__ dparams) {
  using T = Tile<C>;
  constexpr int G = T::G, GP = T::GP, P = T::P, CC = T::CC, GS = T::GS, CS = T::CS;
  constexpr Layout L = T::L;
  extern __shared__ float smem[];
  float* gacc = smem;
  float* sR = gacc + T::kAcc;  // [P][CS] r = x_k[j] - x_q + p_r
  float* sU = sR + T::kR;      // [P][GS] u = h2 W_w1 + b_w1; pass B: [P][CS]
                               // dh2, then dr; at the end [P][18]
  float* sH = sU + T::kU;      // [P][GS] h3; then du
  float* sW = sH + T::kH;      // [P][GS] logits; then the softmax weights
  float* sD = sW + T::kW;      // [P][GS] dw; then ds
  float* sRow = sD + T::kD;    // [P][12] p_rel, z1, pre1, h
  float* sPart = T::kPartInR ? sR : sD;  // pass B: [warp][6][CC] partials
  float* sDh1 = sRow + T::kRow;  // [P][4]
  float* sS1 = sDh1 + T::kDh1;   // s_w1, t_w1
  float* sT1 = sS1 + C;
  int* sJ = reinterpret_cast<int*>(sT1 + C);  // gathered row, -1: masked
  int* sQ = sJ + P;                            // query row, -1: none

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* w1t = params + L.w1t;
  const float* w2 = params + L.w2;
  for (int i = tid; i < T::kAcc; i += kThreads) gacc[i] = 0.f;
  for (int i = tid; i < C; i += kThreads) {
    sS1[i] = params[L.s1 + i];
    sT1[i] = params[L.t1 + i];
  }

  // the gate expressions, one rounding each, the same in both passes
  auto pre2_of = [&](float r, int c) { return __fmaf_rn(r, sS1[c], sT1[c]); };
  auto pre3_of = [&](float u, int g) {
    return __fmaf_rn(u, params[L.s2 + g], params[L.t2 + g]);
  };
  // The elementwise phases give each lane 4 consecutive channels of a row
  // (16-byte loads, stores and atomics): LPR lanes a row, RPI rows a warp
  // at once, ITER such steps cover the warp's rows.  The gathers of two
  // steps are issued before either is used, so their latencies overlap.
  constexpr int LPR = CC / 4, RPI = 32 / LPR, ITER = P / (kWarps * RPI);
  const int sub = lane / LPR, lq = lane % LPR;
  auto row_of = [&](int it) { return (it * kWarps + warp) * RPI + sub; };
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // r of the chunk at c0 into sR (0 on masked rows); with dw, also
  // dw[p][g] += sum over the chunk's channels c of group g of
  // dout[q][c] (x_v[j][c] + p_r[c])
  auto relation = [&](int c0, bool with_dw) {
    const int c = c0 + 4 * lq;
    float pb[4], pw[3][4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      pb[v] = params[L.p2b + c + v];
#pragma unroll
      for (int a = 0; a < 3; ++a) pw[a][v] = params[L.p2w + a * C + c + v];
    }
    constexpr int kBatch = ITER < 2 ? ITER : 2;  // steps whose loads fly together
#pragma unroll
    for (int it0 = 0; it0 < ITER; it0 += kBatch) {
      int jr[kBatch], qr[kBatch];
      float4 vk[kBatch], vq[kBatch], vv[kBatch], vo[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        jr[b] = sJ[row_of(it0 + b)];
        qr[b] = sQ[row_of(it0 + b)];
        const bool on = jr[b] >= 0;
        vk[b] = on ? ld4(xk + (long long)jr[b] * C + c) : zero4;
        vq[b] = on ? ld4(xq + (long long)qr[b] * C + c) : zero4;
        vv[b] = with_dw && on ? ld4(xv + (long long)jr[b] * C + c) : zero4;
        vo[b] = with_dw && on ? ld4(dout + (long long)qr[b] * C + c) : zero4;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int p = row_of(it0 + b);
        const bool on = jr[b] >= 0;
        const float* f = sRow + 12 * p;
        const float k4[4] = {vk[b].x, vk[b].y, vk[b].z, vk[b].w};
        const float q4[4] = {vq[b].x, vq[b].y, vq[b].z, vq[b].w};
        const float v4[4] = {vv[b].x, vv[b].y, vv[b].z, vv[b].w};
        const float o4[4] = {vo[b].x, vo[b].y, vo[b].z, vo[b].w};
        float r[4], dwv[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float pr = attn_pr(pb[v], f[9], f[10], f[11], pw[0][v], pw[1][v], pw[2][v]);
          r[v] = on ? k4[v] - q4[v] + pr : 0.f;
          dwv[v] = with_dw && on ? o4[v] * (v4[v] + pr) : 0.f;
        }
        st4(sR + p * CS + 4 * lq, r);
        if (with_dw) {
          // channels c and c + G of the chunk share a group: lanes lq and
          // lq + G / 4 of the row
#pragma unroll
          for (int off = G / 4; off < LPR; off <<= 1)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              dwv[v] += __shfl_xor_sync(0xffffffffu, dwv[v], off);
          if (4 * lq < G) {
#pragma unroll
            for (int v = 0; v < 4; ++v) sD[p * GS + (4 * lq + v) % G] += dwv[v];
          }
        }
      }
    }
  };

  // the per-group cotangents (d b_w2, d s_w2, d t_w2, d b_w1): thread tid
  // sums group tid % G over rows tid / G + i (256 / G) of every tile in
  // registers, added to the block's accumulator at the end
  constexpr int kColRows = kThreads / G;
  const int col_g = tid % G, col_row0 = tid / G;
  const float col_s2 = params[L.s2 + col_g];
  float col_b2 = 0.f, col_s2acc = 0.f, col_t2 = 0.f, col_b1 = 0.f;
  float p1_acc = 0.f;  // thread tid < 18: the positional MLP's parameter tid

  const long long M = (long long)B * N;
  const long long tiles = (M + TQ - 1) / TQ;
  // row tid's kNN slot of a tile, fetched one tile ahead
  int next_mask = 0, next_idx = 0;
  auto fetch = [&](long long t) {
    const int qi = tid / K, kk = tid % K;
    const long long m = t * TQ + qi;
    const bool on = tid < P && qi < TQ && t < tiles && m < M;
    next_mask = on ? nmask[m * K + kk] : 0;
    next_idx = on ? idx[m * K + kk] : 0;
  };
  fetch(blockIdx.x);
  int KP = 1, log_kp = 0;  // K rounded up to a power of 2
  while (KP < K) {
    KP <<= 1;
    ++log_kp;
  }
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = tile * TQ;
    __syncthreads();  // the previous tile is done with every buffer
    if (tid < P) {
      const int p = tid, qi = p / K;
      const long long m = m0 + qi;
      int j = -1, q = -1;
      if (qi < TQ && m < M) {
        q = (int)m;
        if (next_mask) j = (int)((m / N) * N + next_idx);
      }
      fetch(tile + gridDim.x);  // the next tile's table, read during this one
      sJ[p] = j;
      sQ[p] = q;
      float* f = sRow + 12 * p;
      float prel[3] = {0.f, 0.f, 0.f};
      if (j >= 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          prel[a] = coord[(long long)j * 3 + a] - coord[(long long)q * 3 + a];
      }
      attn_pos_hidden(params, L, prel, f);
#pragma unroll
      for (int o = 0; o < 3; ++o) sDh1[4 * p + o] = 0.f;
    }
    for (int i = tid; i < P * GS; i += kThreads) sD[i] = 0.f;
    __syncthreads();

    // pass A: u = h2 W_w1 over the chunks of C, and dw
    constexpr int MT1 = P / 16, NT1 = GP / 8;
    float uacc[WarpTiles<MT1, NT1>::kTiles][4];
    zero<MT1, NT1>(uacc);
    for (int c0 = 0; c0 < C; c0 += CC) {
      relation(c0, true);
      __syncthreads();
      warp_mma<MT1, NT1, CC / 8>(
          uacc, warp, lane,
          [&](int p, int k) { return fmaxf(pre2_of(sR[p * CS + k], c0 + k), 0.f); },
          [&](int k, int g) { return g < G ? w1t[(long long)g * C + c0 + k] : 0.f; });
      __syncthreads();
    }
    for_fragments<MT1, NT1>(warp, lane, [&](int i, int e, int p, int g) {
      const float u = g < G ? uacc[i][e] + params[L.b1 + g] : 0.f;
      sU[p * GS + g] = u;
      sH[p * GS + g] = g < G ? fmaxf(pre3_of(u, g), 0.f) : 0.f;
    });
    __syncthreads();

    // logits = h3 W_w2 + b_w2
    {
      float acc[WarpTiles<MT1, NT1>::kTiles][4];
      zero<MT1, NT1>(acc);
      warp_mma<MT1, NT1, GP / 8>(
          acc, warp, lane, [&](int p, int k) { return sH[p * GS + k]; },
          [&](int k, int g) { return k < G && g < G ? w2[k * G + g] : 0.f; });
      for_fragments<MT1, NT1>(warp, lane, [&](int i, int e, int p, int g) {
        sW[p * GS + g] = g < G ? acc[i][e] + params[L.b2 + g] : 0.f;
      });
    }
    __syncthreads();

    // the masked softmax over each query's K rows and its backward:
    // w = softmax(logits), ds = w (dw - sum_k w dw); masked rows get 0.
    // KP (K rounded up to a power of 2) consecutive lanes take the rows of
    // one (query, group), reduced with shuffles.
    for (int e0 = 0; e0 < TQ * G * KP; e0 += kThreads) {
      const int e = e0 + tid, kk = e & (KP - 1), g = (e >> log_kp) % G,
                qi = (e >> log_kp) / G;
      const int p = qi * K + kk;
      const bool on = e < TQ * G * KP && kk < K && sJ[p] >= 0;
      const float l = on ? sW[p * GS + g] : -INFINITY;
      const float d = on ? sD[p * GS + g] : 0.f;
      float mx = l;
      for (int off = 1; off < KP; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float x = on ? expf(l - mx) : 0.f;
      float den = x, dot = x * d;
      for (int off = 1; off < KP; off <<= 1) {
        den += __shfl_xor_sync(0xffffffffu, den, off);
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      if (e < TQ * G * KP && kk < K) {
        const float inv = 1.f / den;
        const float wgt = on ? x * inv : 0.f;
        sW[p * GS + g] = wgt;
        sD[p * GS + g] = on ? wgt * (d - dot * inv) : 0.f;
      }
    }
    __syncthreads();

    // d W_w2 += h3^T ds, d b_w2 += sum ds, and dh3 = ds W_w2^T
    constexpr int MT2 = (G + 15) / 16;
    {
      float acc[WarpTiles<MT2, NT1>::kTiles][4];
      zero<MT2, NT1>(acc);
      warp_mma<MT2, NT1, P / 8>(
          acc, warp, lane,
          [&](int g, int p) { return g < G ? sH[p * GS + g] : 0.f; },
          [&](int p, int g) { return sD[p * GS + g]; });
      for_fragments<MT2, NT1>(warp, lane, [&](int i, int e, int g0, int g) {
        if (g0 < G && g < G) gacc[L.w2 + g0 * G + g] += acc[i][e];
      });
    }
#pragma unroll
    for (int p = col_row0; p < P; p += kColRows) col_b2 += sD[p * GS + col_g];
    float dh3[WarpTiles<MT1, NT1>::kTiles][4];
    zero<MT1, NT1>(dh3);
    warp_mma<MT1, NT1, GP / 8>(
        dh3, warp, lane, [&](int p, int k) { return sD[p * GS + k]; },
        [&](int k, int g) { return k < G && g < G ? w2[g * G + k] : 0.f; });
    __syncthreads();  // h3 is read no more
    for_fragments<MT1, NT1>(warp, lane, [&](int i, int e, int p, int g) {
      sH[p * GS + g] = g < G && pre3_of(sU[p * GS + g], g) > 0.f ? dh3[i][e] : 0.f;
    });
    __syncthreads();
    // d s_w2, d t_w2, d b_w1 over the tile's rows; du = dpre3 s_w2 in place
#pragma unroll
    for (int p = col_row0; p < P; p += kColRows) {
      const float d = sH[p * GS + col_g];
      const float du = d * col_s2;
      col_s2acc += d * sU[p * GS + col_g];
      col_t2 += d;
      col_b1 += du;
      sH[p * GS + col_g] = du;
    }

    // pass B, chunk by chunk: dh2 = du W_w1^T, d W_w1 += h2^T du, then the
    // elementwise backward of r and the positional encoding
    constexpr int MT3 = CC / 16;
    for (int c0 = 0; c0 < C; c0 += CC) {
      __syncthreads();  // du ready / the previous chunk done with sR, sU, sD
      if constexpr (C > CC) {  // else sR still holds pass A's r
        relation(c0, false);
        __syncthreads();
      }
      {
        float acc[WarpTiles<MT1, CC / 8>::kTiles][4];
        zero<MT1, CC / 8>(acc);
        warp_mma<MT1, CC / 8, GP / 8>(
            acc, warp, lane, [&](int p, int g) { return sH[p * GS + g]; },
            [&](int g, int c) { return g < G ? w1t[(long long)g * C + c0 + c] : 0.f; });
        for_fragments<MT1, CC / 8>(warp, lane, [&](int i, int e, int p, int c) {
          sU[p * CS + c] = acc[i][e];
        });
      }
      {
        float acc[WarpTiles<MT3, NT1>::kTiles][4];
        zero<MT3, NT1>(acc);
        warp_mma<MT3, NT1, P / 8>(
            acc, warp, lane,
            [&](int c, int p) { return fmaxf(pre2_of(sR[p * CS + c], c0 + c), 0.f); },
            [&](int p, int g) { return sH[p * GS + g]; });
        for_fragments<MT3, NT1>(warp, lane, [&](int i, int e, int c, int g) {
          if (g < G) gacc[L.w1t + g * C + c0 + c] += acc[i][e];
        });
      }
      __syncthreads();

      // per row: dr = [pre2 > 0] dh2 s_w1 -> d x_k[j]; dout w -> d x_v[j];
      // dp_r = dout w + dr -> d W_p2, d b_p2 and dh of the positional MLP
      // (masked rows hold dh2 = 0 and dout = 0 here, so add 0 everywhere)
      {
        const int c = c0 + 4 * lq;
        // dout of the next step's row is read while this step runs; the
        // loop stays rolled (128 registers)
        auto dout_of = [&](int it) {
          const int p = row_of(it);
          return sJ[p] >= 0 ? ld4(dout + (long long)sQ[p] * C + c) : zero4;
        };
        float4 vo_next = dout_of(0);
        float s1v[4], pw[3][4], part[6][4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          s1v[v] = sS1[c + v];
#pragma unroll
          for (int a = 0; a < 3; ++a) pw[a][v] = params[L.p2w + a * C + c + v];
#pragma unroll
          for (int a = 0; a < 6; ++a) part[a][v] = 0.f;
        }
#pragma unroll 1
        for (int it = 0; it < ITER; ++it) {
          const int p = row_of(it), j = sJ[p];
          const float4 vo = vo_next;
          if (it + 1 < ITER) vo_next = dout_of(it + 1);
          const float* f = sRow + 12 * p;
          const float4 r4 = ld4(sR + p * CS + 4 * lq);
          const float4 h4 = ld4(sU + p * CS + 4 * lq);
          const float4 w4 = ld4(sW + p * GS + (4 * lq) % G);
          const float r[4] = {r4.x, r4.y, r4.z, r4.w};
          const float dh2[4] = {h4.x, h4.y, h4.z, h4.w};
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
          const float o[4] = {vo.x, vo.y, vo.z, vo.w};
          float dr[4], dv[4], dh1[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float dpre2 = pre2_of(r[v], c + v) > 0.f ? dh2[v] : 0.f;
            dr[v] = dpre2 * s1v[v];
            dv[v] = o[v] * w[v];
            const float dpr = dv[v] + dr[v];
            part[0][v] += f[9] * dpr;
            part[1][v] += f[10] * dpr;
            part[2][v] += f[11] * dpr;
            part[3][v] += dpr;
            part[4][v] += dpre2 * r[v];
            part[5][v] += dpre2;
#pragma unroll
            for (int a = 0; a < 3; ++a) dh1[a] += dpr * pw[a][v];
          }
          if (j >= 0) {
            red4(dxk + (long long)j * C + c, dr);
            red4(dxv + (long long)j * C + c, dv);
          }
          st4(sU + p * CS + 4 * lq, dr);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int off = LPR / 2; off > 0; off >>= 1)
              dh1[a] += __shfl_xor_sync(0xffffffffu, dh1[a], off);
          }
          if (lq == 0) {
#pragma unroll
            for (int a = 0; a < 3; ++a) sDh1[4 * p + a] += dh1[a];
          }
        }
        // the warp's per-channel partials: sum over its rows, then one
        // store a channel
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
#pragma unroll
            for (int off = LPR; off < 32; off <<= 1)
              part[a][v] += __shfl_xor_sync(0xffffffffu, part[a][v], off);
          }
        if constexpr (T::kPartInR) __syncthreads();  // every warp is done with r
        if (sub == 0) {
#pragma unroll
          for (int a = 0; a < 6; ++a) st4(sPart + (warp * 6 + a) * CC + 4 * lq, part[a]);
        }
      }
      __syncthreads();

      // d x_q = -sum over the query's rows of dr; the per-channel partials
      for (int e = tid; e < TQ * CC; e += kThreads) {
        const int qi = e / CC, cl = e % CC;
        const long long m = m0 + qi;
        if (m >= M) continue;
        float s = 0.f;
        for (int kk = 0; kk < K; ++kk) s += sU[(qi * K + kk) * CS + cl];
        dxq[m * C + c0 + cl] = -s;
      }
      for (int e = tid; e < 6 * CC; e += kThreads) {
        const int a = e / CC, cl = e % CC;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sPart[(w * 6 + a) * CC + cl];
        const int at = a < 3 ? L.p2w + a * C : a == 3 ? L.p2b : a == 4 ? L.s1 : L.t1;
        gacc[at + c0 + cl] += s;
      }
    }
    __syncthreads();

    // the positional MLP's first layer, row by row into sU, then one
    // thread a parameter sums the rows
    if (tid < P) {
      const int p = tid;
      const float* f = sRow + 12 * p;
      float v[18];
#pragma unroll
      for (int a = 0; a < 18; ++a) v[a] = 0.f;
      if (sJ[p] >= 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float dpre1 = f[6 + i] > 0.f ? sDh1[4 * p + i] : 0.f;
          const float dz1 = dpre1 * params[L.ps + i];
          v[12 + i] = dpre1 * f[3 + i];
          v[15 + i] = dpre1;
          v[9 + i] = dz1;
#pragma unroll
          for (int a = 0; a < 3; ++a) v[a * 3 + i] = f[a] * dz1;
        }
      }
#pragma unroll
      for (int a = 0; a < 18; ++a) sU[p * 18 + a] = v[a];
    }
    __syncthreads();
    if (tid < 18) {
#pragma unroll 8
      for (int p = 0; p < P; ++p) p1_acc += sU[p * 18 + tid];
    }
  }
  atomicAdd(&gacc[L.b2 + col_g], col_b2);
  atomicAdd(&gacc[L.s2 + col_g], col_s2acc);
  atomicAdd(&gacc[L.t2 + col_g], col_t2);
  atomicAdd(&gacc[L.b1 + col_g], col_b1);
  if (tid < 18) gacc[tid] += p1_acc;  // p1w (9), p1b, ps, pt: the layout's first 18
  __syncthreads();
  for (int i = tid; i < L.total; i += kThreads) atomicAdd(&dparams[i], gacc[i]);
}

template <int C>
int launch(const float* xq, const float* xk, const float* xv,
           const float* coord, const int* idx, const uint8_t* nmask,
           const float* params, const float* dout, int B, int N, int K,
           float* dxq, float* dxk, float* dxv, float* dparams,
           cudaStream_t stream) {
  using T = Tile<C>;
  const int TQ = T::P / K;  // whole queries a tile
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, attn_bwd_kernel<C>, kThreads, T::kBytes)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // persistent blocks: each ends with L.total atomics
  const long long M = (long long)B * N;
  const long long tiles = (M + TQ - 1) / TQ;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(tiles < resident ? tiles : resident);
  attn_bwd_kernel<C><<<grid, kThreads, T::kBytes, stream>>>(
      xq, xk, xv, coord, idx, nmask, params, dout, B, N, K, TQ, dxq, dxk, dxv,
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
