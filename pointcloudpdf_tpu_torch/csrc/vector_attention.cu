// K3: PT-v1 vector attention, forward (inference, and the training forward
// of K4 with batch-statistic affines).
//
// Replaces the TPU kernel fused_vector_attention
// (pointcloudpdf_tpu/ops/pallas_attention.py, _attn_kernel).  Per query
// point, over its K neighbours j (nmask false -> probability 0):
//   p_rel = coord[j] - coord_q
//   p_r   = relu((p_rel W_p1 + b_p1) * s_p + t_p) W_p2 + b_p2         (C)
//   r     = relu((x_k[j] - x_q + p_r) * s_w1 + t_w1)                   (C)
//   a     = relu((r W_w1 + b_w1) * s_w2 + t_w2)                        (G)
//   logit = a W_w2 + b_w2                                              (G)
//   out[c] = sum_j softmax_j(logit)[c % G] * (x_v[j][c] + p_r[c])
// with G = C / share.  The BatchNorm affines (s, t) arrive folded: from the
// running statistics in eval, from the batch's masked statistics in
// training (vector_attention_bwd.cu is the backward).  A query without a
// valid neighbour comes out 0.
//
// Bound on the card.  Per valid pair the function gathers two rows (x_k and
// x_v, 8 C bytes) and does the C x G product h2 W_w1 (2 C G flop) against
// ~16 C flop of everything else; each query reads x_q and writes out once.
// At C <= 64 the gathers take the time (at the train step's first stage the
// crop is shuffled, so the rows come from device memory, not L2); at
// C >= 256 the product would bound it on the CUDA cores, so it runs on the
// tensor cores.
//
// Design: a warp takes tasks of 16 pair rows, the rows of an mma m-tile:
// TQ whole queries of K slots (at most two; masked slots and the rows past
// the last query are rows without a pair), or, where K > 16, one query's
// slots in row chunks of 16 merged by an online softmax whose running max
// and sums live in the warp's shared memory and whose running value lives
// in out.  The warps run their tasks independently: after the block loads
// its shared parameters there is no block-wide barrier, so one warp's
// gathers overlap the others' products.  One block an SM, of 8 to 20 warps
// by width (Shape::kWarps).  A task:
//   rows: j, q and the positional MLP's hidden values h of each row, from
//     coordinates copied (cp.async) while the warp ran its last task, and
//     the kNN table read two tasks ahead;
//   the rows staged in the warp's shared memory with 16-byte cp.async
//     (a fragment's own 4-byte gathers touch eight cache lines an
//     instruction): x_k and x_q up to C = 128, x_v (zeros on a row without
//     a pair) up to C = 64; at C = 32, where the shuffled crop's rows come
//     from device memory, x_v copied while the warp runs the task before;
//   U = h2 W_w1 (16 x G, k = C) on the tensor cores, mma.sync m16n8k8 in
//     split TF32, each lane making h2 = relu((x_k[j] - x_q + p_r) s1 + t1)
//     of its A fragment in registers (p_r from the row's h); W_w1 comes
//     split into TF32 (hi, lo) pairs by the wrapper's packing and stays in
//     shared memory (up to C = 256; read through L1/L2 at 512);
//   h3 = relu((U + b1) s2 + t2) in the accumulators, which serve as the A
//     fragments of logits = h3 W_w2 + b2 (k permuted: k slot t <-> column
//     2 t, t + 4 <-> 2 t + 1, W_w2's rows read in the same order);
//   the masked softmax of each (query, group), with the sums of w and of
//     w h: in the logits' fragments by shuffles where a task is one query
//     of 16 slots or two of 8, else from the warp's shared memory.  Those
//     sums give the weighted p_r without per-pair work: sum_j w p_r[j][c]
//     = b_p2[c] sum_j w + sum_a W_p2[a][c] sum_j w h_a;
//   out[q, c] = sum_j w[j][c % G] x_v[j][c] + that, 16-byte reads and
//     stores.
// U is summed in the backward's order (vector_attention.cuh: k-steps in
// order, each k-step's a_lo b_hi + a_hi b_lo + a_hi b_hi summed from 0 and
// added to an f32 sum, hi and lo rounded as split_tf32 rounds them), and
// every ReLU input is the backward's expression, so the backward's
// recompute opens the same gates.  Split TF32 keeps f32 accuracy where
// one-pass TF32 (10-bit mantissas) misses the 1e-4 tolerance.  G = 4
// (C = 32) is padded to the mma's n = 8 with zero columns.  Everything
// else is f32 on the CUDA cores.

#include "vector_attention.cuh"

namespace {

using Layout = pcpdf::AttnLayout;
using pcpdf::attn_pos_hidden;
using pcpdf::attn_pr;
using pcpdf::cp_async16;
using pcpdf::cp_async16_zfill;
using pcpdf::cp_async4;
using pcpdf::cp_async_commit;
using pcpdf::cp_async_wait;
using pcpdf::mma_split;
using pcpdf::split_tf32;

constexpr int kRows = 16;  // pair rows a warp's task: one m-tile of the mma
constexpr int kTQW = 2;    // whole queries a task, at most

// One width's shapes and shared memory, in floats
template <int C>
struct Shape {
  static constexpr int G = C / 8;
  static constexpr int GP = G < 8 ? 8 : G;  // groups, padded to the mma's n
  static constexpr int NT = GP / 8;         // n-tiles of U and the logits
  static constexpr int KT = C / 8;          // k-steps of U
  static constexpr Layout L = pcpdf::attn_layout(C, G);
  // W_w1's pairs stay in shared memory up to C = 256 (74 KB there); at
  // C = 512 (272 KB) they are read through L1/L2
  static constexpr bool kW1Shared = C <= 256;
  static constexpr int WS1 = 2 * GP + 8;  // W_w1 pair rows: conflict-free
  static constexpr int WS2 = 2 * GP + 4;  // W_w2 pair rows, read 2 rows apart
  static constexpr int GS = GP + 4;       // logits / weights rows
  // one block an SM of kWarps warps: 16 (at most 128 registers a thread),
  // 20 at C = 32 (102), 12 at C = 256 (168), 8 at C = 512 (255), as the
  // registers ask or allow
  static constexpr int kWarps = C == 512 ? 8 : C == 256 ? 12 : C == 32 ? 20 : 16;
  static constexpr int kThreads = 32 * kWarps;
  // a task's rows staged in the warp's shared memory by cp.async (16-byte
  // copies, a few cache lines an instruction, where the fragments' own
  // 4-byte gathers touch eight): x_k and x_q up to C = 128, x_v up to
  // C = 64, above that gathered where they are used; at C = 32 x_v is
  // copied while the warp runs the task before (kPreV: two buffers; the
  // same for x_k and x_q was slower there)
  static constexpr bool kStageK = C <= 128;
  static constexpr bool kStageV = C <= 64;
  static constexpr bool kPreV = C <= 32;
  static constexpr int VS = C + 4;        // their row stride: conflict-free
  static constexpr int kW1 = kW1Shared ? C * WS1 : 0;
  static constexpr int kW2 = GP * WS2;
  // a warp's own: logits / weights, h of each row, the next task's
  // coordinates (x_j, x_q a row), the sums of w and w h a (query, group),
  // the running max / sum / factor (K > 16), rows j and q
  static constexpr int kWarp = kRows * GS + kRows * 4 + kRows * 8 +
                               kTQW * GP * 4 + 3 * GP + 2 * kRows +
                               (kStageK ? (kRows + kTQW) * VS : 0) +
                               (kStageV ? (kPreV ? 2 : 1) * kRows * VS : 0);
  static constexpr int kFloats = kW1 + kW2 + 6 * C + 4 * GP + kWarps * kWarp;
  static constexpr size_t kBytes = (size_t)kFloats * 4;
  static_assert(kBytes <= 232448, "shared memory of one block");
  static_assert(kWarp % 4 == 0 && (kW1 + kW2) % 4 == 0, "16-byte rows");
};

template <int C>
__global__ void __launch_bounds__(Shape<C>::kThreads, 1)
attn_kernel(const float* __restrict__ xq, const float* __restrict__ xk,
            const float* __restrict__ xv, const float* __restrict__ coord,
            const int* __restrict__ idx, const uint8_t* __restrict__ nmask,
            const float* __restrict__ params, const float* __restrict__ w1s,
            int B, int N, int K, int SS, int TQ, float* __restrict__ out) {
  using S = Shape<C>;
  constexpr int G = S::G, GP = S::GP, NT = S::NT, KT = S::KT, WS1 = S::WS1,
                WS2 = S::WS2, GS = S::GS, VS = S::VS, kThreads = S::kThreads,
                kWarps = S::kWarps;
  constexpr Layout L = S::L;
  extern __shared__ __align__(16) float smem[];
  float* sW1 = smem;                                   // [C][WS1] W_w1 pairs
  float* sW2 = sW1 + S::kW1;                           // [GP][WS2] W_w2 pairs
  float4* sPc = reinterpret_cast<float4*>(sW2 + S::kW2);  // [C] b_p2, W_p2[.][c]
  float2* sSt = reinterpret_cast<float2*>(sPc + C);       // [C] s_w1, t_w1
  float4* sGp = reinterpret_cast<float4*>(sSt + C);       // [GP] b_w1, s_w2, t_w2, b_w2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  float* sWt = reinterpret_cast<float*>(sGp + GP) + warp * S::kWarp;  // [16][GS]
  float* sH = sWt + kRows * GS;            // [16][4] h of each row
  float* sXyz = sH + kRows * 4;            // [16][8] the next task's x_j, x_q
  float* sSh = sXyz + kRows * 8;           // [kTQW][GP][4] sum w, w h_0..2
  float* sMax = sSh + kTQW * GP * 4;       // [GP] running max (K > 16)
  float* sSum = sMax + GP;                 //   ... sum
  float* sScale = sSum + GP;               //   ... factor of the earlier rows
  int* sJ = reinterpret_cast<int*>(sScale + GP);  // [16] gathered row, -1: none
  int* sQ = sJ + kRows;                            // [16] query row, -1: none
  // staged rows (kStageK / kStageV; x_v in two buffers where kPreV)
  float* sXk = reinterpret_cast<float*>(sQ + kRows);  // [16][VS] x_k, [kTQW][VS] x_q
  constexpr int kKBuf = S::kStageK ? (kRows + kTQW) * VS : 0;  // x_k, x_q a buffer
  float* sXv = sXk + kKBuf;                           // [16][VS] x_v
  constexpr int kVBuf = kRows * VS;

  // the block's shared parameters: W_w1's pairs (as the packing split them;
  // padding groups 0), W_w2 split into pairs, per channel the positional
  // encoding's second layer and the first BatchNorm's affine, per group the
  // weight encoding's biases and its BatchNorm's affine
  if constexpr (S::kW1Shared) {
    for (int e = tid; e < C * GP; e += kThreads) {
      const int k = e / GP, g = e % GP;
      *reinterpret_cast<float2*>(sW1 + k * WS1 + 2 * g) =
          g < G ? *reinterpret_cast<const float2*>(w1s + (k * G + g) * 2)
                : make_float2(0.f, 0.f);
    }
  }
  for (int e = tid; e < GP * GP; e += kThreads) {
    const int k = e / GP, g = e % GP;
    uint32_t hi = 0, lo = 0;
    if (k < G && g < G) split_tf32(params[L.w2 + k * G + g], hi, lo);
    *reinterpret_cast<float2*>(sW2 + k * WS2 + 2 * g) =
        make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
  for (int c = tid; c < C; c += kThreads) {
    sPc[c] = make_float4(params[L.p2b + c], params[L.p2w + c], params[L.p2w + C + c],
                         params[L.p2w + 2 * C + c]);
    sSt[c] = make_float2(params[L.s1 + c], params[L.t1 + c]);
  }
  for (int g = tid; g < GP; g += kThreads)
    sGp[g] = g < G ? make_float4(params[L.b1 + g], params[L.s2 + g], params[L.t2 + g],
                                 params[L.b2 + g])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the only block-wide barrier

  // This warp's tasks, one after the other: tiles of TQ whole queries x SS
  // slots in 16 pair rows, tile gw, gw + nw, ...; where K > 16 a query's
  // slots in row chunks of 16.  Indices are 32-bit: B N max(K, C) < 2^31
  // (the entry checks).
  const int M = B * N;
  const int nw = gridDim.x * kWarps;
  const bool merged = SS < K;  // TQ = 1
  struct Task {
    int m0, s0;  // first query and slot; m0 >= M: past the warp's last
  };
  auto after = [&](Task t) {
    t.s0 += SS;
    if (t.s0 >= K) {
      t.s0 = 0;
      t.m0 += nw * TQ;
    }
    return t;
  };
  // lane l < 16 writes row l: query l / SS of the task, slot l % SS
  const int my_q = lane < kRows ? lane / SS : TQ, my_s = lane % SS;
  // a task of one query of 16 slots or two of 8: the softmax in the logits
  // fragments, without a pass through shared memory
  const bool fragment_softmax = !merged && TQ * SS == kRows && (SS == 16 || SS == 8);
  // else lanes a (query, group) of the softmax: as many as 32 lanes and SS
  // allow
  int LPI = 1, log_lpi = 0;
  while (2 * LPI * TQ * G <= 32 && 2 * LPI <= SS) {
    LPI <<= 1;
    ++log_lpi;
  }
  // row l's kNN slot, read two tasks ahead, and its rows and coordinates
  // (cp.async into sXyz), one task ahead
  int reg_mask = 0, reg_idx = 0, nx_j = -1, nx_q = -1;
  auto fetch = [&](Task t) {
    const int m = t.m0 + my_q, s = t.s0 + my_s;
    const bool on = my_q < TQ && m < M && s < K;
    reg_mask = on ? nmask[m * K + s] : 0;
    reg_idx = on ? idx[m * K + s] : 0;
  };
  auto prepare = [&](Task t) {
    const int m = t.m0 + my_q;
    const bool in = my_q < TQ && m < M && t.s0 + my_s < K;
    nx_q = in ? m : -1;
    nx_j = in && reg_mask ? (m / N) * N + reg_idx : -1;
    if (nx_j >= 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cp_async4(reinterpret_cast<int*>(sXyz + 8 * lane + a),
                  reinterpret_cast<const int*>(coord + nx_j * 3 + a));
        cp_async4(reinterpret_cast<int*>(sXyz + 8 * lane + 4 + a),
                  reinterpret_cast<const int*>(coord + nx_q * 3 + a));
      }
    }
  };

  // x_k and x_q (kv = false) or x_v (kv = true) of a task's rows into the
  // staging buffer dst: row r's gathered row row_j(r), query qi's row
  // row_q(qi) (-1: none), both warp-uniform calls
  auto stage = [&](bool kv, float* dst, auto row_j, auto row_q) {
    for (int e = lane; e < kRows * (C / 4); e += 32) {
      const int r = e / (C / 4), c4 = 4 * (e % (C / 4)), j = row_j(r);
      if (kv)  // zeros on a row without a pair: its weight is 0 too
        cp_async16_zfill(dst + r * VS + c4, xv + (j < 0 ? 0 : j) * C + c4, j >= 0);
      else if (j >= 0)
        cp_async16(dst + r * VS + c4, xk + j * C + c4);
    }
    if (kv) return;
    static_assert(kTQW == 2, "the queries' rows below");
    const int qrow0 = row_q(0), qrow1 = row_q(1);  // (every lane: shuffles)
    for (int e = lane; e < kTQW * (C / 4); e += 32) {
      const int qi = e / (C / 4), c4 = 4 * (e % (C / 4)), q = qi ? qrow1 : qrow0;
      if (qi < TQ && q >= 0) cp_async16(dst + (kRows + qi) * VS + c4, xq + q * C + c4);
    }
  };
  // the rows of the task prepare() has just set up, from the lanes' registers
  auto next_j = [&](int r) { return __shfl_sync(0xffffffffu, nx_j, r); };
  auto next_q = [&](int qi) { return __shfl_sync(0xffffffffu, nx_q, min(qi * SS, kRows - 1)); };
  // the current task's, from the warp's shared memory
  auto cur_j = [&](int r) { return sJ[r]; };
  auto cur_q = [&](int qi) { return sQ[min(qi * SS, kRows - 1)]; };

  Task cur = {(int)(blockIdx.x * kWarps + warp) * TQ, 0};
  fetch(cur);
  prepare(cur);
  if constexpr (S::kPreV) stage(true, sXv, next_j, next_q);
  cp_async_commit();
  fetch(after(cur));
  int par = 0;  // the x_v buffer of the current task (kPreV)
  for (Task nxt = after(cur); cur.m0 < M; cur = nxt, nxt = after(nxt), par ^= 1) {
    const int m0 = cur.m0;
    const bool first = cur.s0 == 0, last = cur.s0 + SS >= K;
    __syncwarp();  // the last task is done with the warp's buffers
    // everything the last task set in flight: this task's coordinates and
    // its prefetched rows
    cp_async_wait<0>();
    __syncwarp();
    // rows: j, q and the positional MLP's hidden values h
    if (lane < kRows) {
      float prel[3] = {0.f, 0.f, 0.f}, f[12];
      if (nx_j >= 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) prel[a] = sXyz[8 * lane + a] - sXyz[8 * lane + 4 + a];
      }
      attn_pos_hidden(params, L, prel, f);
      sJ[lane] = nx_j;
      sQ[lane] = nx_q;
      *reinterpret_cast<float4*>(sH + 4 * lane) = make_float4(f[9], f[10], f[11], 0.f);
    }
    __syncwarp();
    // three commit groups a task: this task's x_k and x_q, its x_v where
    // not prefetched, then the next task's coordinates and prefetched x_v
    float* xv_buf = sXv + (S::kPreV ? par * kVBuf : 0);
    if constexpr (S::kStageK) stage(false, sXk, cur_j, cur_q);
    cp_async_commit();
    if constexpr (S::kStageV && !S::kPreV) stage(true, xv_buf, cur_j, cur_q);
    cp_async_commit();
    prepare(nxt);  // the next task's rows and coordinates
    if constexpr (S::kPreV) stage(true, sXv + (par ^ 1) * kVBuf, next_j, next_q);
    cp_async_commit();
    fetch(after(nxt));

    // U = h2 W_w1 (16 rows x GP, K = C) on the tensor cores, its A
    // fragments made in registers from the gathered rows: lane (gid, tig)
    // holds rows gid and gid + 8, channels tig and tig + 4 of each k-step
    const int j0 = sJ[gid], j1 = sJ[gid + 8];
    const int q0 = sQ[gid] < 0 ? 0 : sQ[gid], q1 = sQ[gid + 8] < 0 ? 0 : sQ[gid + 8];
    const float4 h0 = *reinterpret_cast<const float4*>(sH + 4 * gid);
    const float4 h1 = *reinterpret_cast<const float4*>(sH + 4 * (gid + 8));
    // the A elements' rows: staged in shared memory, or in device memory
    const float* k0 = S::kStageK ? sXk + gid * VS : xk + (j0 < 0 ? 0 : j0) * C;
    const float* k1 = S::kStageK ? sXk + (gid + 8) * VS : xk + (j1 < 0 ? 0 : j1) * C;
    const float* x0 = S::kStageK ? sXk + (kRows + min(gid / SS, TQ - 1)) * VS : xq + q0 * C;
    const float* x1 = S::kStageK ? sXk + (kRows + min((gid + 8) / SS, TQ - 1)) * VS
                                 : xq + q1 * C;
    if constexpr (S::kStageK) {
      cp_async_wait<2>();  // x_k and x_q (then x_v and the next task's in flight)
      __syncwarp();
    }
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll(KT <= 8 ? KT : C >= 512 ? 1 : 2)  // C <= 64: all gathers at once
    for (int kk = 0; kk < KT; ++kk) {
      const int c = 8 * kk + tig;
      const float4 pa = sPc[c], pb = sPc[c + 4];
      const float2 sa = sSt[c], sb = sSt[c + 4];
      // the A elements (row gid, c), (gid + 8, c), (gid, c + 4), (gid + 8, c + 4)
      const float kv[4] = {k0[c], k1[c], k0[c + 4], k1[c + 4]};
      const float qv[4] = {x0[c], x1[c], x0[c + 4], x1[c + 4]};
      const bool on[4] = {j0 >= 0, j1 >= 0, j0 >= 0, j1 >= 0};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 h = i & 1 ? h1 : h0;
        const float4 pc = i < 2 ? pa : pb;
        const float2 st = i < 2 ? sa : sb;
        const float pr = attn_pr(pc.x, h.x, h.y, h.z, pc.y, pc.z, pc.w);
        const float r = on[i] ? kv[i] - qv[i] + pr : 0.f;
        split_tf32(fmaxf(__fmaf_rn(r, st.x, st.y), 0.f), ah[i], al[i]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int g = 8 * n + gid;
        float2 b0, b1;
        if constexpr (S::kW1Shared) {
          b0 = *reinterpret_cast<const float2*>(sW1 + c * WS1 + 2 * g);
          b1 = *reinterpret_cast<const float2*>(sW1 + (c + 4) * WS1 + 2 * g);
        } else {
          b0 = __ldg(reinterpret_cast<const float2*>(w1s + (c * G + g) * 2));
          b1 = __ldg(reinterpret_cast<const float2*>(w1s + ((c + 4) * G + g) * 2));
        }
        const uint32_t bh[2] = {__float_as_uint(b0.x), __float_as_uint(b1.x)};
        const uint32_t bl[2] = {__float_as_uint(b0.y), __float_as_uint(b1.y)};
        mma_split(acc[n], ah, al, bh, bl);
      }
    }

    // h3 = relu((U + b1) s2 + t2), in place; then logits = h3 W_w2 + b2 with
    // the accumulator fragments as A fragments (k slot t <-> column 2 t,
    // t + 4 <-> 2 t + 1, W_w2's rows read in the same order)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = 8 * n + 2 * tig + (e & 1);
        const float4 gp = sGp[g];
        acc[n][e] = g < G ? fmaxf(__fmaf_rn(acc[n][e] + gp.x, gp.y, gp.z), 0.f) : 0.f;
      }
    constexpr int NH = NT > 4 ? 4 : NT;  // logit n-tiles at once (registers)
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NH) {
      float lg[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) lg[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ah[4], al[4];
        split_tf32(acc[kk][0], ah[0], al[0]);
        split_tf32(acc[kk][2], ah[1], al[1]);
        split_tf32(acc[kk][1], ah[2], al[2]);
        split_tf32(acc[kk][3], ah[3], al[3]);
        const int k = 8 * kk + 2 * tig;
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          const int g = 8 * (n0 + n) + gid;
          const float2 b0 = *reinterpret_cast<const float2*>(sW2 + k * WS2 + 2 * g);
          const float2 b1 = *reinterpret_cast<const float2*>(sW2 + (k + 1) * WS2 + 2 * g);
          const uint32_t bh[2] = {__float_as_uint(b0.x), __float_as_uint(b1.x)};
          const uint32_t bl[2] = {__float_as_uint(b0.y), __float_as_uint(b1.y)};
          mma_split(lg[n], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int g = 8 * (n0 + n) + 2 * tig;
        const float b0 = sGp[g].w, b1 = sGp[g + 1].w;
        if (!fragment_softmax) {
          *reinterpret_cast<float2*>(sWt + gid * GS + g) = make_float2(lg[n][0] + b0, lg[n][1] + b1);
          *reinterpret_cast<float2*>(sWt + (gid + 8) * GS + g) =
              make_float2(lg[n][2] + b0, lg[n][3] + b1);
          continue;
        }
        // the softmax in the fragments: column g + p, rows gid (e = p) and
        // gid + 8 (e = 2 + p); a column's rows reduced by shuffles over gid
        // (lanes 4 apart), both halves at once where they are one query
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float bias = p ? b1 : b0;
          const float l0 = j0 >= 0 ? lg[n][p] + bias : -INFINITY;
          const float l1 = j1 >= 0 ? lg[n][2 + p] + bias : -INFINITY;
          float m0x = l0, m1x = l1;
          if (SS == 16) m0x = m1x = fmaxf(l0, l1);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            m0x = fmaxf(m0x, __shfl_xor_sync(0xffffffffu, m0x, off));
            if (SS != 16) m1x = fmaxf(m1x, __shfl_xor_sync(0xffffffffu, m1x, off));
          }
          if (SS == 16) m1x = m0x;
          const float x0 = j0 >= 0 ? expf(l0 - m0x) : 0.f;
          const float x1 = j1 >= 0 ? expf(l1 - m1x) : 0.f;
          // (sum w, sum w h_a) of each half
          float a[4] = {x0, x0 * h0.x, x0 * h0.y, x0 * h0.z};
          float b[4] = {x1, x1 * h1.x, x1 * h1.y, x1 * h1.z};
          if (SS == 16) {  // one query: the halves' sums are one
#pragma unroll
            for (int v = 0; v < 4; ++v) a[v] += b[v];
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              a[v] += __shfl_xor_sync(0xffffffffu, a[v], off);
              if (SS != 16) b[v] += __shfl_xor_sync(0xffffffffu, b[v], off);
            }
          if (SS == 16) {
#pragma unroll
            for (int v = 0; v < 4; ++v) b[v] = a[v];
          }
          const float ia = a[0] > 0.f ? 1.f / a[0] : 0.f, ib = b[0] > 0.f ? 1.f / b[0] : 0.f;
          sWt[gid * GS + g + p] = x0 * ia;
          sWt[(gid + 8) * GS + g + p] = x1 * ib;
          if (gid == 0) {
            *reinterpret_cast<float4*>(sSh + (g + p) * 4) =
                make_float4(a[0] * ia, a[1] * ia, a[2] * ia, a[3] * ia);
            if (SS == 8)
              *reinterpret_cast<float4*>(sSh + (GP + g + p) * 4) =
                  make_float4(b[0] * ib, b[1] * ib, b[2] * ib, b[3] * ib);
          }
        }
      }
    }
    __syncwarp();

    // the masked softmax of each (query, group) over its slots, LPI lanes
    // each (every LPI-th slot, their sums added by shuffles),
    // with the sums of w and of w h over the slots (sSh), from which the
    // aggregation adds the weighted p_r: sum_j w p_r[j][c] = b_p2[c] sum_j w
    // + sum_a W_p2[a][c] sum_j w h_a.  Where the query's slots are all here,
    // the weights themselves; else exp(logit - running max), merged into the
    // running sums.
    for (int it0 = 0; !fragment_softmax && it0 < TQ * G * LPI; it0 += 32) {
      const int e = it0 + lane, sl = e & (LPI - 1), it = e >> log_lpi;
      const bool in = it < TQ * G;
      const int qi = in ? it / G : 0, g = it % G;
      float* wq = sWt + qi * SS * GS + g;
      const int* jq = sJ + qi * SS;
      float mx = -INFINITY;
#pragma unroll 4
      for (int si = sl; in && si < SS; si += LPI) mx = jq[si] >= 0 ? fmaxf(mx, wq[si * GS]) : mx;
      for (int off = 1; off < LPI; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float scale = 1.f;
      if (merged) {
        const float run = first ? -INFINITY : sMax[g], nm = fmaxf(run, mx);
        scale = nm == -INFINITY ? 1.f : expf(run - nm);
        mx = nm;
      }
      float sum[4] = {0.f, 0.f, 0.f, 0.f};  // w, w h_0, w h_1, w h_2
#pragma unroll 4
      for (int si = sl; in && si < SS; si += LPI) {
        const float4 h = *reinterpret_cast<const float4*>(sH + 4 * (qi * SS + si));
        const float x = jq[si] >= 0 ? expf(wq[si * GS] - mx) : 0.f;
        wq[si * GS] = x;
        sum[0] += x;
        sum[1] += x * h.x;
        sum[2] += x * h.y;
        sum[3] += x * h.z;
      }
      for (int off = 1; off < LPI; off <<= 1)
#pragma unroll
        for (int v = 0; v < 4; ++v) sum[v] += __shfl_xor_sync(0xffffffffu, sum[v], off);
      if (!in) continue;
      float* shq = sSh + (qi * GP + g) * 4;
      if (merged) {
        if (sl == 0) {
          if (!first) {
            sum[0] += sSum[g] * scale;
#pragma unroll
            for (int v = 1; v < 4; ++v) sum[v] += shq[v] * scale;
          }
          sMax[g] = mx;
          sSum[g] = sum[0];
          sScale[g] = scale;
          *reinterpret_cast<float4*>(shq) = make_float4(sum[0], sum[1], sum[2], sum[3]);
        }
      } else {
        const float inv = sum[0] > 0.f ? 1.f / sum[0] : 0.f;
#pragma unroll 4
        for (int si = sl; si < SS; si += LPI) wq[si * GS] *= inv;
        if (sl == 0)
          *reinterpret_cast<float4*>(shq) =
              make_float4(sum[0] * inv, sum[1] * inv, sum[2] * inv, sum[3] * inv);
      }
    }
    __syncwarp();

    // out[q, c..c+3] = sum over the query's rows of w[c % G] x_v[j][c], plus
    // the weighted p_r: LPR lanes cover a row's channels (4 a lane, C / 128
    // groups of them at C >= 128), RPI rows at once, their sums added by
    // shuffles.  A query's slots in row chunks: the running value in out,
    // with p_r's share and the division by the running sum after the last
    // chunk.
    if constexpr (S::kStageV && !S::kPreV) {
      cp_async_wait<1>();  // x_v (the next task's still in flight)
      __syncwarp();
    }
    constexpr int LPR = C / 4 < 32 ? C / 4 : 32, RPI = 32 / LPR, NC4 = C / (4 * LPR);
    const int sub = lane / LPR, l4 = 4 * (lane % LPR);
    for (int qi = 0; qi < TQ; ++qi) {
      const int m = m0 + qi;
      if (m >= M) break;
#pragma unroll
      for (int t = 0; t < NC4; ++t) {
        const int c = l4 + 4 * LPR * t, g = c % G;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int si = sub; si < SS; si += RPI) {
          float4 x;
          if constexpr (S::kStageV) {  // zeros where the row has no pair
            x = *reinterpret_cast<const float4*>(xv_buf + (qi * SS + si) * VS + c);
          } else {
            const int j = sJ[qi * SS + si];
            if (j < 0) continue;
            x = __ldg(reinterpret_cast<const float4*>(xv + j * C + c));
          }
          const float4 w = *reinterpret_cast<const float4*>(sWt + (qi * SS + si) * GS + g);
          a[0] += w.x * x.x;
          a[1] += w.y * x.y;
          a[2] += w.z * x.z;
          a[3] += w.w * x.w;
        }
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
          for (int v = 0; v < 4; ++v) a[v] += __shfl_xor_sync(0xffffffffu, a[v], off);
        if (sub != 0) continue;
        if (!first) {
          const float4 o = *reinterpret_cast<const float4*>(out + m * C + c);
          a[0] += o.x * sScale[g];
          a[1] += o.y * sScale[g + 1];
          a[2] += o.z * sScale[g + 2];
          a[3] += o.w * sScale[g + 3];
        }
        if (last) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 sh = *reinterpret_cast<const float4*>(sSh + (qi * GP + g + v) * 4);
            const float4 pc = sPc[c + v];
            a[v] += pc.x * sh.x + pc.y * sh.y + pc.z * sh.z + pc.w * sh.w;
            if (merged) a[v] = sh.x > 0.f ? a[v] / sh.x : 0.f;
          }
        }
        *reinterpret_cast<float4*>(out + m * C + c) = make_float4(a[0], a[1], a[2], a[3]);
      }
    }
  }
}

template <int C>
int launch(const float* xq, const float* xk, const float* xv,
           const float* coord, const int* idx, const uint8_t* nmask,
           const float* params, const float* w1s, int B, int N, int K,
           float* out, cudaStream_t stream) {
  using S = Shape<C>;
  constexpr int kThreads = S::kThreads, kWarps = S::kWarps;
  const int M = B * N;
  if (K == 0)  // no neighbour slot: every query comes out 0
    return (int)cudaMemsetAsync(out, 0, (size_t)M * C * sizeof(float), stream);
  const int SS = K < kRows ? K : kRows;                   // slots a task
  const int TQ = kRows / SS < kTQW ? kRows / SS : kTQW;   // queries a task
  auto kernel = attn_kernel<C>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, S::kBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // persistent blocks, each warp over its own tasks
  const long long tasks = ((long long)M + TQ - 1) / TQ;
  const long long blocks = (tasks + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(blocks < resident ? blocks : resident);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(xq, xk, xv, coord, idx, nmask,
                                                 params, w1s, B, N, K, SS, TQ, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x_q/x_k/x_v (B, N, C) f32, coord (B, N, 3) f32, idx (B, N, K) i32,
// nmask (B, N, K) u8, params packed as attn_layout(C, C/8), w1s (C, 2 C/8):
// W_w1 [in][out] split into TF32 (hi, lo) pairs, hi = x rounded to TF32 and
// lo = x - hi rounded to TF32 -> out (B, N, C).  share = 8, C in {32, 64,
// 128, 256, 512}, any K >= 0.
extern "C" int pcpdf_vector_attention(const void* xq, const void* xk,
                                      const void* xv, const void* coord,
                                      const void* idx, const void* nmask,
                                      const void* params, const void* w1s,
                                      int B, int N, int C, int K, void* out,
                                      void* stream) {
  if ((long long)B * N == 0) return 0;
  // the kernel's indices are 32-bit
  if (K < 0 || (long long)B * N * (K > C ? K : C) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  auto q = static_cast<const float*>(xq);
  auto k = static_cast<const float*>(xk);
  auto v = static_cast<const float*>(xv);
  auto c = static_cast<const float*>(coord);
  auto i = static_cast<const int*>(idx);
  auto nm = static_cast<const uint8_t*>(nmask);
  auto p = static_cast<const float*>(params);
  auto w = static_cast<const float*>(w1s);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<32>(q, k, v, c, i, nm, p, w, B, N, K, o, s);
    case 64: return launch<64>(q, k, v, c, i, nm, p, w, B, N, K, o, s);
    case 128: return launch<128>(q, k, v, c, i, nm, p, w, B, N, K, o, s);
    case 256: return launch<256>(q, k, v, c, i, nm, p, w, B, N, K, o, s);
    case 512: return launch<512>(q, k, v, c, i, nm, p, w, B, N, K, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// floats in the packed parameter buffer for width C (share 8)
extern "C" int pcpdf_vector_attention_params(int C) {
  return pcpdf::attn_layout(C, C / 8).total;
}
