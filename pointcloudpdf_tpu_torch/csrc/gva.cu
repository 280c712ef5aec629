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
// a C x C product for every (query, neighbour) pair, 2 C^2 flop (86% of the
// work at C = 384), and the weight encoding a C x G one, 2 C G flop, against
// ~16 C bytes a query.  Both products run on the tensor cores, as the TPU
// kernel runs them on its MXU over a tile of pair rows:
//
// - A persistent block (8 warps) takes tiles of TQ whole queries x SS slots,
//   P pair rows (masked slots, slots past S and rows past the last query are
//   rows with j = -1), so each query's softmax closes inside the tile.  S
//   need not divide P (SS = min(S, P), TQ = P / SS rows in use); where S > P
//   a query's slots come in row chunks of P, merged by an online softmax
//   whose running sum lives in shared memory and running value in out.
// - Y = H W2 over C in chunks of NC output channels.  W2 comes split into
//   TF32 (hi, lo) pairs by the wrapper's packing (once a module) and
//   streams through shared memory in k-slabs of 16 x NC (cp.async, three
//   buffers, one barrier a slab).  A warp takes 16 rows x WN n-tiles.  The
//   hidden layer H = relu((p W1 + b1) s + t) never goes to shared memory:
//   each warp makes its A fragments in registers from its two rows' p and
//   the layer's weights with the BatchNorm folded in (4 floats a channel,
//   resident), since shared memory's bandwidth, not the tensor cores,
//   bounded the products when H was staged there (a split fragment is
//   twice the bytes of an f32 one).  Products are mma.sync m16n8k8 in
//   split TF32 (as K4's backward, common.cuh: integer hi/lo splits, lo
//   rounded, each k-step's three products summed from 0 and added to an
//   f32 sum on the CUDA cores), which keeps f32 accuracy where one-pass
//   TF32 (10-bit mantissas) does not.
// - The weight encoding in the same pass: as a chunk of Y is finished, its
//   accumulators become rel = (k[j] - q_i) pem + peb in registers, and since
//   an mma's accumulator fragment, read with the k index permuted (k slot
//   t <-> column 2t, t + 4 <-> 2t + 1), is the A fragment of the next
//   product, rel W_e1 (the chunk's rows of W_e1, staged in shared memory)
//   accumulates straight into the warp's a fragments.  v[j] is gathered
//   beside k[j] and q_i, and v_eff = v[j] + peb goes to shared memory.  No
//   (B, N, S, C) intermediate goes to device memory.  The G -> G layer, the
//   masked softmax over each query's slots and out[c] = sum softmax * v_eff
//   close the tile on the CUDA cores, from shared memory.
//
// W2 a tile reads from L2, per encoding that is on: C^2 x 8 bytes (hi and
// lo), i.e. 18 KB at C = 48 and 74 KB at 96 (P = 128 rows: 144 / 576 bytes
// a row), 295 KB at 192, 1.2 MB at 384 and 2.1 MB at 512 (P = 64: 4.6 / 18
// / 33 KB a row).  A row's split-TF32 products cost 6 C^2 flop, so a
// tile does 0.75 P flop for each byte of W2, 48 at P = 64: at the rate this
// kernel reaches that is ~2 TB/s from L2, and P = 32 would double it.
// P = 128 would halve it, but v_eff for the tile (P x C f32) is 98 KB at
// C = 384 and 130 KB at 512 with P = 64: twice that does not fit beside the
// slabs.  At C <= 192 two blocks share an SM (128 registers a thread; the
// multiplier's variants, which no shipped config uses, one); at C = 192
// one block of P = 128 was 8% faster at N = 16,384 but 10% slower on the
// PT-v2m2 forward's smaller sets, where fewer warps hide less latency.
// What bounds it now, measured on the card: at C >= 192 the slab loop,
// which issues ~4.6 instructions for each mma (the H fragments, the B
// fragments' loads and the f32 sums of the split products) with a barrier
// every two k-steps; at C <= 96 the per-tile phases (rows, softmax,
// aggregation), which wait on memory and barriers.
// Every sum is in f32 and the inputs are f32 (no bf16 payload).

#include "common.cuh"

namespace {

using pcpdf::cp_async16;
using pcpdf::cp_async4;
using pcpdf::cp_async_commit;
using pcpdf::cp_async_wait;
using pcpdf::mma_split;
using pcpdf::split_tf32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// The shape of one width's tile and its shared memory, in floats
template <int C>
struct Tile {
  static constexpr int G = C / 8;
  static constexpr int GP = (G + 7) / 8 * 8;   // groups, padded to mma's n
  static constexpr int NT = GP / 8;            // n-tiles of the weight encoding
  static constexpr int P = C <= 96 ? 128 : 64;   // pair rows a tile
  static constexpr int MT = P / 16;              // m-tiles: a warp takes one
  static constexpr int WC = kWarps / MT;         // warps sharing an m-tile
  static constexpr int WN = C == 48 ? 6 : C == 384 ? 8 : 4;  // n-tiles a warp, a chunk
  static constexpr int NC = 8 * WN * WC;         // channels a chunk
  static constexpr int NCH = C / NC;             // chunks
  static constexpr int KS = 16;                  // k rows a slab of W2
  static constexpr int KSL = C / KS;             // slabs a chunk and branch
  static constexpr int TQMAX = P / 8;            // queries a tile, at most
  // row strides: conflict-free fragment reads and writes
  static constexpr int WS = 2 * NC + 8;  // W2 slab: (hi, lo) pairs
  static constexpr int ES = NC + 8;      // W_e1 chunk: a group a row
  static constexpr int LS = GP + 1;      // a, then the logits / weights
  static constexpr int PS = C + 8;       // v_eff
  static constexpr int kW = KS * WS;     // three buffers
  static constexpr int kE = GP * ES;     // two buffers
  static constexpr int kA = P * LS;      // a and the logits, then W_e2,
                                         // in the buffers above
  static constexpr int kStats = TQMAX * GP;
  static constexpr int kVe = P * PS;
  static constexpr int kFloats =
      3 * kW + 2 * kE + 8 * C + 3 * kStats + 4 * P + 2 * P + kVe;
  static constexpr size_t kBytes = (size_t)kFloats * 4;
  // two blocks an SM (128 registers a thread), or one
  static constexpr int kMinBlocks = C <= 192 ? 2 : 1;
  static_assert(C % NC == 0 && C % KS == 0 && NC % 4 == 0, "widths of the tile");
  static_assert(MT * WC == kWarps, "a warp an m-tile and column group");
  static_assert(kBytes <= 232448, "shared memory of one block");
  static_assert(kMinBlocks == 1 || 2 * (kBytes + 1024) <= 233472, "two blocks an SM");
  static_assert(3 * kW + 2 * kE >= 2 * kA + G * G, "a, logits and W_e2 in the slabs");
  static_assert(gva_layout(C, G).e1t % 4 == 0, "W_e1 rows 16-byte aligned");
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// kMul: the multiplier encoding is on (its accumulators exist, and take the
// registers of a second block); the bias encoding's switch is pe_bias
template <int C, bool kMul>
__global__ void __launch_bounds__(kThreads, kMul ? 1 : Tile<C>::kMinBlocks)
gva_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ coord,
           const int* __restrict__ idx, const uint8_t* __restrict__ nmask,
           const float* __restrict__ params, const float* __restrict__ pm2,
           const float* __restrict__ pb2, int pe_bias, int B, int N, int S,
           int SS, int TQ, float* __restrict__ out) {
  using T = Tile<C>;
  constexpr int G = T::G, NT = T::NT, P = T::P, MT = T::MT, WN = T::WN,
                NC = T::NC, NCH = T::NCH, KS = T::KS, KSL = T::KSL,
                WS = T::WS, ES = T::ES, LS = T::LS, PS = T::PS;
  constexpr GvaLayout L = gva_layout(C, G);
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;                    // 3 x [KS][WS] W2 slabs, split
  float* sE = smem + 3 * T::kW;        // 2 x [GP][ES] W_e1 of a chunk,
                                       //   transposed
  float* sA = smem;                    // after the chunks, in the above: a,
  float* sL = smem + T::kA;            //   the logits / softmax weights
  float* sE2 = smem + 2 * T::kA;       //   and W_e2
  float4* sHp = reinterpret_cast<float4*>(sE + 2 * T::kE);  // [2][C]: the
                                       //   hidden layers' (W1 s, b1 s + t)
  float* sMax = reinterpret_cast<float*>(sHp + 2 * C);  // [TQ][G] running max
  float* sSum = sMax + T::kStats;      //   ... sum
  float* sScale = sSum + T::kStats;    //   ... factor of the earlier rows
  float4* sRp = reinterpret_cast<float4*>(sScale + T::kStats);  // [P] p
  int* sJ = reinterpret_cast<int*>(sRp + P);  // [P] row j, -1: no pair
  int* sNext = sJ + P;  // [P] the next row chunk's kNN indices
  float* sVe = reinterpret_cast<float*>(sNext + P);  // [P][PS] v_eff = v[j] + peb

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp % MT, wc = warp / MT;  // this warp's m-tile, n-tiles
  // each encoding's first layer with its BatchNorm folded in: h = relu(b' +
  // p W1'), W1' = W1 s, b' = b1 s + t (the multiplier's at [0, C), the
  // bias's at [C, 2 C); zeros for a branch that is off)
  for (int i = tid; i < 2 * C; i += kThreads) {
    const int c = i % C, o = i < C ? L.m1w : L.b1w;
    const float sc = params[o + 4 * C + c];
    sHp[i] = make_float4(params[o + c] * sc, params[o + C + c] * sc,
                         params[o + 2 * C + c] * sc,
                         params[o + 3 * C + c] * sc + params[o + 5 * C + c]);
  }

  const int per_chunk = ((int)kMul + pe_bias) * KSL;  // slabs a chunk
  const int total = NCH * per_chunk;                  // slabs a row chunk
  const int M = B * N;  // B N S and B N C < 2^31 (the launch checks)
  const int tiles = (M + TQ - 1) / TQ;

  // slab t of a row chunk (its chunk, branch and k-slab): W2's rows, split,
  // into buffer t % 3
  auto issue_w2 = [&](int t) {
    if (t >= total) return;
    const int chunk = t / per_chunk, r = t % per_chunk;
    const float* w2 = kMul && r < KSL ? pm2 : pb2;
    const int k0 = (r % KSL) * KS;
    float* dst = sW + (t % 3) * T::kW;
    for (int e = tid; e < KS * NC / 2; e += kThreads) {
      const int kr = e / (NC / 2), n4 = 4 * (e % (NC / 2));
      cp_async16(dst + kr * WS + n4,
                 w2 + (long long)(k0 + kr) * 2 * C + chunk * 2 * NC + n4);
    }
  };
  // W_e1's rows of a chunk, transposed ([g][channel]), into buffer chunk % 2
  // (rows G to GP - 1, the padding to mma's n, feed only columns of ea that
  // are never read)
  auto issue_e1 = [&](int chunk) {
    if (chunk >= NCH) return;
    float* dst = sE + (chunk & 1) * T::kE;
    for (int e = tid; e < G * (NC / 4); e += kThreads) {
      const int g = e / (NC / 4), n4 = 4 * (e % (NC / 4));
      cp_async16(dst + g * ES + n4, params + L.e1t + g * C + chunk * NC + n4);
    }
  };
  // acc += H (this warp's 16 rows) . W2 slab (KS x this warp's WN n-tiles),
  // H's A fragments made in registers from the rows' p (rp0: row gid, rp1:
  // gid + 8; read again at each k-step where two blocks share the SM's
  // registers) and the branch's folded first layer hp at channels k0 + ...
  constexpr bool kLean = T::kMinBlocks == 2;
  float3 rp0, rp1;
  auto load_rp = [&] {
    const float4 a = sRp[16 * mt + gid], b = sRp[16 * mt + gid + 8];
    rp0 = make_float3(a.x, a.y, a.z);
    rp1 = make_float3(b.x, b.y, b.z);
  };
  auto slab_mma = [&](const float4* hp, int k0, const float* w, float (&acc)[WN][4]) {
#pragma unroll(kLean ? 1 : KS / 8)
    for (int ks = 0; ks < KS / 8; ++ks) {
      if (kLean) load_rp();
      const int c0 = 8 * ks + tig;
      const float4 pa = hp[k0 + c0], pb = hp[k0 + c0 + 4];
      const float a[4] = {
          fmaxf(pa.w + rp0.x * pa.x + rp0.y * pa.y + rp0.z * pa.z, 0.f),
          fmaxf(pa.w + rp1.x * pa.x + rp1.y * pa.y + rp1.z * pa.z, 0.f),
          fmaxf(pb.w + rp0.x * pb.x + rp0.y * pb.y + rp0.z * pb.z, 0.f),
          fmaxf(pb.w + rp1.x * pb.x + rp1.y * pb.y + rp1.z * pb.z, 0.f)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int n = 8 * (wc * WN + j) + gid;
        const float2 b0 = ld2(w + c0 * WS + 2 * n);
        const float2 b1 = ld2(w + (c0 + 4) * WS + 2 * n);
        const uint32_t bh[2] = {__float_as_uint(b0.x), __float_as_uint(b1.x)};
        const uint32_t bl[2] = {__float_as_uint(b0.y), __float_as_uint(b1.y)};
        mma_split(acc[j], ah, al, bh, bl);
      }
    }
  };

  // the kNN index of this thread's row (tid < P) of a row chunk, copied
  // one row chunk ahead into sNext
  auto fetch = [&](int tile, int s0) {
    const int qi = tid / SS, s = s0 + tid % SS, m = tile * TQ + qi;
    if (tid < P && tile < tiles && qi < TQ && m < M && s < S)
      cp_async4(sNext + tid, idx + m * S + s);
    cp_async_commit();
  };
  fetch(blockIdx.x, 0);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * TQ;
    for (int s0 = 0; s0 < S; s0 += SS) {
      __syncthreads();  // the last row chunk is done with every buffer
      int my_j = -1;
      cp_async_wait<0>();  // this thread's sNext
      if (tid < P) {
        // the mask and the coordinates (of a row clamped into the sample)
        // loaded together
        const int qi = tid / SS, s = s0 + tid % SS, m = m0 + qi;
        const bool in = qi < TQ && m < M && s < S;
        const int mm = in ? m : 0, j = (mm / N) * N + min(max(sNext[tid], 0), N - 1);
        const uint8_t mask = nmask[in ? m * S + s : 0];
        const bool on = in && mask;
        const float4 rp = make_float4(coord[j * 3] - coord[mm * 3],
                                      coord[j * 3 + 1] - coord[mm * 3 + 1],
                                      coord[j * 3 + 2] - coord[mm * 3 + 2], 0.f);
        my_j = on ? j : -1;
        sJ[tid] = my_j;
        sRp[tid] = on ? rp : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (s0 + SS < S)
        fetch(tile, s0 + SS);
      else
        fetch(tile + gridDim.x, 0);
      if (s0 == 0) {
        for (int e = tid; e < TQ * G; e += kThreads) {
          sMax[e] = -INFINITY;
          sSum[e] = 0.f;
        }
      }
      if (__syncthreads_or(my_j >= 0)) {
        // the weight encoding's first layer, accumulated over the chunks:
        // this warp's 16 rows x GP groups (a partial over its WN n-tiles)
        float ea[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ea[n][e] = 0.f;
        // one cp.async group a slab: group t holds slab t's W2; group 0 also
        // chunk 0's W_e1, and the group issued at chunk c's first slab chunk
        // c + 1's (waited two slabs later, in use at chunk c + 1's end)
        issue_w2(0);
        issue_e1(0);
        cp_async_commit();
        issue_w2(1);
        cp_async_commit();
        if (!kLean) load_rp();
        for (int chunk = 0; chunk < NCH; ++chunk) {
          float accm[kMul ? WN : 1][4], accb[WN][4];
#pragma unroll
          for (int j = 0; j < WN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              accb[j][e] = 0.f;
              if (kMul) accm[j][e] = 0.f;
            }
          for (int r = 0; r < per_chunk; ++r) {
            const int t = chunk * per_chunk + r;
            cp_async_wait<1>();  // slab t's group (the newest is t + 1's)
            // slab t's W2 visible to all; every warp is done with slab t - 1
            // and with the last chunk's W_e1
            __syncthreads();
            issue_w2(t + 2);
            if (r == 0) issue_e1(chunk + 1);
            cp_async_commit();
            const float* w = sW + (t % 3) * T::kW;
            const int k0 = (r % KSL) * KS;
            if constexpr (kMul) {
              if (r < KSL)
                slab_mma(sHp, k0, w, accm);
              else
                slab_mma(sHp + C, k0, w, accb);
            } else {
              slab_mma(sHp + C, k0, w, accb);
            }
          }
          if (per_chunk == 0) {  // no positional encoding: W_e1 alone
            if (chunk > 0) {
              __syncthreads();
              issue_e1(chunk);
              cp_async_commit();
            }
            cp_async_wait<0>();
            __syncthreads();
          }
          // the chunk's Y is done: rel and v_eff, and rel W_e1 into ea
          {
            const float* e1 = sE + (chunk & 1) * T::kE;
            int jr[2];
            int mr[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * mt + gid + 8 * h;
              jr[h] = sJ[row];
              mr[h] = m0 + row / SS;
            }
            // the gathers of JB n-tiles first, from row 0 for a row without
            // a pair, so that their latencies overlap (as many as the
            // registers hold)
            constexpr int JB = T::kMinBlocks == 2 ? 1 : kMul ? WN / 4 : WN / 2;
#pragma unroll
            for (int j0 = 0; j0 < WN; j0 += JB) {
              float2 kv[JB][2], qv[JB][2], vv[JB][2];
#pragma unroll
              for (int jb = 0; jb < JB; ++jb)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int c = chunk * NC + 8 * (wc * WN + j0 + jb) + 2 * tig;
                  const bool on = jr[h] >= 0;
                  const long long j = on ? (long long)jr[h] : 0ll;
                  kv[jb][h] = ld2(k + j * C + c);
                  vv[jb][h] = ld2(v + j * C + c);
                  qv[jb][h] = ld2(q + (on ? (long long)mr[h] : 0ll) * C + c);
                }
#pragma unroll
              for (int jb = 0; jb < JB; ++jb) {
                const int j = j0 + jb;
                const int cl = 8 * (wc * WN + j) + 2 * tig, c = chunk * NC + cl;
                float rel[4];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int row = 16 * mt + gid + 8 * h;
                  const bool on = jr[h] >= 0;
                  float x[2] = {kv[jb][h].x - qv[jb][h].x, kv[jb][h].y - qv[jb][h].y};
                  float pb[2];
#pragma unroll
                  for (int d = 0; d < 2; ++d) {
                    if constexpr (kMul) x[d] *= accm[j][2 * h + d] + params[L.m2b + c + d];
                    pb[d] = accb[j][2 * h + d] + params[L.b2b + c + d];
                    if (pe_bias) x[d] += pb[d];
                    rel[2 * h + d] = on ? x[d] : 0.f;
                  }
                  *reinterpret_cast<float2*>(sVe + row * PS + c) =
                      pe_bias ? make_float2(vv[jb][h].x + pb[0], vv[jb][h].y + pb[1])
                              : vv[jb][h];
                }
                // the accumulator fragment as an A fragment, k permuted
                uint32_t ah[4], al[4];
                split_tf32(rel[0], ah[0], al[0]);
                split_tf32(rel[2], ah[1], al[1]);
                split_tf32(rel[1], ah[2], al[2]);
                split_tf32(rel[3], ah[3], al[3]);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                  const float2 b = ld2(e1 + (8 * n + gid) * ES + cl);
                  uint32_t bh[2], bl[2];
                  split_tf32(b.x, bh[0], bl[0]);
                  split_tf32(b.y, bh[1], bl[1]);
                  mma_split(ea[n], ah, al, bh, bl);
                }
              }
            }
          }
        }
        __syncthreads();  // every warp is done with the slabs and W_e1

        // a = relu((rel W_e1 + b_e1) s_e + t_e), the warps' partials summed;
        // W_e2 beside it
        for (int i = tid; i < G * G; i += kThreads) sE2[i] = params[L.e2w + i];
        auto store_a = [&](bool finish) {
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = 16 * mt + gid + 8 * (e >> 1), g = 8 * n + 2 * tig + (e & 1);
              if (g < G) {
                float* a = sA + row * LS + g;
                if (!finish)
                  *a = ea[n][e];
                else
                  *a = fmaxf((ea[n][e] + (T::WC > 1 ? *a : 0.f) + params[L.e1b + g]) *
                                 params[L.es + g] + params[L.et + g], 0.f);
              }
            }
        };
        if (T::WC > 1) {
          if (wc == 1) store_a(false);
          __syncthreads();
          if (wc == 0) store_a(true);
        } else {
          store_a(true);
        }
        __syncthreads();  // a and W_e2 ready
      }

      // the logits l = a W_e2 + b_e2 of the rows that hold a pair, and the
      // masked softmax of each (query, group) over this row chunk's slots,
      // merged into the running max and sum: KP lanes (SS rounded up to a
      // power of 2, at most 32) a (query, group); sL takes exp(l - max)
      int KP = 1;
      while (KP < SS && KP < 32) KP <<= 1;
      for (int e0 = 0; e0 < TQ * G * KP; e0 += kThreads) {
        const int e = e0 + tid, sub = e % KP, qg = e / KP;
        const bool on = e < TQ * G * KP;
        const int qi = qg / G, g = qg % G;
        float mx = -INFINITY;
        for (int si = sub; on && si < SS; si += KP) {
          const int p = qi * SS + si;
          if (sJ[p] >= 0) {
            const float* a = sA + p * LS;
            float part[4] = {params[L.e2b + g], 0.f, 0.f, 0.f};  // 4 chains
#pragma unroll
            for (int h = 0; h < G; ++h) part[h % 4] += a[h] * sE2[h * G + g];
            const float l = (part[0] + part[1]) + (part[2] + part[3]);
            sL[p * LS + g] = l;
            mx = fmaxf(mx, l);
          }
        }
        for (int off = 1; off < KP; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float run = on ? sMax[qg] : -INFINITY, nm = fmaxf(run, mx);
        const float scale = nm == -INFINITY ? 1.f : expf(run - nm);
        float sum = 0.f;
        for (int si = sub; on && si < SS; si += KP) {
          const int p = qi * SS + si;
          const float x = sJ[p] >= 0 ? expf(sL[p * LS + g] - nm) : 0.f;
          sL[p * LS + g] = x;
          sum += x;
        }
        for (int off = 1; off < KP; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (on && sub == 0) {
          sMax[qg] = nm;
          sSum[qg] = sSum[qg] * scale + sum;
          sScale[qg] = scale;
        }
      }
      __syncthreads();
      // out[c] = sum over the slots of w[c / 8] v_eff[c]: the running value
      // in out, divided by the sum after the last row chunk
      const bool last = s0 + SS >= S;
      for (int e = tid; e < TQ * C; e += kThreads) {
        const int qi = e / C, c = e % C, g = c / 8;
        const int m = m0 + qi;
        if (m >= M) continue;
        // (a slot without a pair has weight 0); two chains of sums
        auto term = [&](int si) {
          const int p = qi * SS + si;
          return sJ[p] >= 0 ? sL[p * LS + g] * sVe[p * PS + c] : 0.f;
        };
        float acc0 = s0 == 0 ? 0.f : out[m * C + c] * sScale[qi * G + g], acc1 = 0.f;
        int si = 0;
#pragma unroll 8
        for (; si + 1 < SS; si += 2) {
          acc0 += term(si);
          acc1 += term(si + 1);
        }
        if (si < SS) acc0 += term(si);
        float sum = acc0 + acc1;
        if (last) {
          const float den = sSum[qi * G + g];
          sum = den > 0.f ? sum / den : 0.f;
        }
        out[m * C + c] = sum;
      }
    }
  }
}

template <int C, bool kMul>
int launch_with(const float* q, const float* k, const float* v,
                const float* coord, const int* idx, const uint8_t* nmask,
                const float* params, const float* pm2, const float* pb2,
                int pe_bias, int B, int N, int S, float* out,
                cudaStream_t stream) {
  using T = Tile<C>;
  const long long M = (long long)B * N;
  if (S == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)M * C * sizeof(float), stream);
  const int SS = S < T::P ? S : T::P;
  const int TQ = T::P / SS < T::TQMAX ? T::P / SS : T::TQMAX;
  auto kernel = gva_kernel<C, kMul>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, T::kBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // persistent blocks over the tiles of TQ queries
  const long long tiles = (M + TQ - 1) / TQ;
  const long long resident = (long long)per_sm * sms;
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, kThreads, T::kBytes, stream>>>(
      q, k, v, coord, idx, nmask, params, pm2, pb2, pe_bias, B, N, S, SS, TQ, out);
  return (int)cudaGetLastError();
}

template <int C>
int launch(const float* q, const float* k, const float* v, const float* coord,
           const int* idx, const uint8_t* nmask, const float* params,
           const float* pm2, const float* pb2, int pe_mul, int pe_bias, int B,
           int N, int S, float* out, cudaStream_t stream) {
  return pe_mul ? launch_with<C, true>(q, k, v, coord, idx, nmask, params, pm2, pb2,
                                       pe_bias, B, N, S, out, stream)
                : launch_with<C, false>(q, k, v, coord, idx, nmask, params, pm2, pb2,
                                        pe_bias, B, N, S, out, stream);
}

}  // namespace

// q/k/v (B, N, C) f32, coord (B, N, 3) f32, idx (B, N, S) i32 rows of the
// same sample, nmask (B, N, S) u8, params packed as gva_layout(C, C / 8),
// pm2/pb2 (C, 2 C): the (C, C) [in][out] matrices split into TF32 (hi, lo)
// pairs, hi = x rounded to TF32 and lo = x - hi rounded to TF32 (read only
// for a branch that is on) -> out (B, N, C) f32.  8 channels a group, C in
// {48, 96, 192, 384, 512}.
extern "C" int pcpdf_gva(const void* q, const void* k, const void* v,
                         const void* coord, const void* idx, const void* nmask,
                         const void* params, const void* pm2, const void* pb2,
                         int pe_mul, int pe_bias, int B, int N, int C, int S,
                         void* out, void* stream) {
  if ((long long)B * N == 0) return 0;
  // the kernel's indices are 32-bit
  if (S < 0 || (long long)B * N * (S > C ? S : C) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
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
