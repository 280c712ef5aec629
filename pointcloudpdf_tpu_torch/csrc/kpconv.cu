// K6: kernel-point convolution (KPConv) over a neighbour table, inference
// forward.
//
// Replaces the TPU kernel band_kpconv (pointcloudpdf_tpu/ops/
// pallas_kpconv.py, _kpconv_kernel with its _sort_rank band).  Per point i,
// over its S neighbour slots j (nmask false -> no contribution):
//   infl[p][j] = max(0, 1 - |x_j - x_i - kp_p| / sigma_r)
//   A_i        = infl_i F_i          (P x S) (S x C_in)
//   y_i        = sum_p A_i[p] W_p    = A_i (P C_in) . W (P C_in x C_out)
// The TPU kernel searches its neighbours itself, in a z-order rank band
// (uncapped, ~0.06% of in-radius pairs missed), because that chip has no
// cheap gather; here the table comes from the exact kNN kernel (the S
// nearest in-radius points) and rows are gathered by index, which is the
// JAX package's exact path.
//
// Bound on the card: the latency of the gather of the neighbours'
// coordinates and rows from L2 and of the influences (a square root and a
// division where a neighbour lies within sigma_r of a kernel point), not
// the bytes of the inputs or the products' flops.  Design: a persistent
// block of kWarps warps takes tiles of kTile points, a warp kPointsPerWarp
// of them, one at a time, in a pipeline: a point's rows are copied into
// shared memory (cp.async) while the warp computes the point before it,
// and the table entries of the point after it are loaded meanwhile.
//  1. Pairs.  The point's valid slots (lanes take slots lane and lane +
//     32) are compacted in slot order by ballot: their feature rows into F
//     (valid slots x C_in), their coordinates into a list.  Lanes then take
//     the listed pairs and write their P influences into I (P x valid
//     slots) in the plain version's arithmetic (__fsub_rn, (dx*dx + dy*dy)
//     + dz*dz unfused, __fsqrt_rn, __fdiv_rn): the squared distances to
//     every kernel point first, independent of each other; where one is at
//     least the smallest float >= sigma_r^2 the influence is 0 for certain
//     (sqrt >= sigma_r, so the quotient rounds to >= 1) and is written as 0
//     with no root and no division; the few below it (~7% on the ST stem's
//     tables) are then computed in full, one at a time.  The influences
//     equal the plain version's bit for bit.
//  2. The point's product A_i = I_i F_i on the tensor cores (mma.sync
//     m16n8k8: P -> 16 rows, C_in -> 8 or 16 columns, k-steps over the
//     valid slots only), into the tile's row of A (kTile x P C_in, padded
//     to a multiple of 8).  F's rows past the valid count up to the k-step
//     are 0, so I's columns there may hold another point's (finite)
//     influences; a padded point, or one with no valid slot, gets a row of
//     0.
//  3. The tile's product Y = A W (kTile x P C_in . P C_in x C_out) on the
//     tensor cores, W read through L1, its rows written out.
// Both products run in split TF32 (common.cuh): f32 accuracy.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;  // points a tile: one m16 tile of Y = A W
constexpr int kPointsPerWarp = kTile / kWarps;
constexpr int kMaxS = 40, kMaxP = 16, kMaxCin = 16, kMaxCout = 64;
constexpr unsigned kFull = 0xffffffffu;
using pcpdf::cp_async_commit;
using pcpdf::cp_async_wait;

// Shared-memory layout in floats, from the shapes.  Row strides are chosen
// for conflict-free mma fragment reads: I's (SK + 4) and A's (PCK + 4) are
// odd multiples of 4 modulo 32; F's is C_in rounded up to 4 (8 below 8:
// conflict-free; 12 and 16 with two-way conflicts).
struct Layout {
  int SK, IS, FS, PC, PCK, AS, NT;
  int kp, a, warp0, i, f, nbr, rows, per_warp, total;
  __host__ __device__ Layout(int S, int P, int Cin, int Cout) {
    SK = (S + 7) & ~7;
    IS = SK + 4;
    FS = Cin <= 8 ? 8 : (Cin + 3) & ~3;
    PC = P * Cin;
    PCK = (PC + 7) & ~7;
    AS = PCK + 4;
    NT = (Cout + 7) >> 3;
    kp = 0;                    // (16) float4
    a = kp + 4 * kMaxP;        // (kTile, AS)
    warp0 = a + kTile * AS;
    i = 0;                     // a warp's: (16, IS) influences
    f = i + 16 * IS;           //   (2, SK, FS) feature rows, by point parity
    nbr = f + 2 * SK * FS;     //   (2, SK) float4 neighbour coordinates
    rows = nbr + 2 * 4 * SK;   //   (SK) int rows of the valid slots
    per_warp = rows + SK;
    total = warp0 + kWarps * per_warp;
  }
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(src), "n"(BYTES)
               : "memory");
}

// a pair's influence on one kernel point, in the plain version's operations
__device__ __forceinline__ float influence(float d2, float sigma_r) {
  return fmaxf(__fsub_rn(1.f, __fdiv_rn(__fsqrt_rn(d2), sigma_r)), 0.f);
}

template <int NT1>  // n-tiles of C_in: 1 (C_in <= 8) or 2 (C_in <= 16)
__global__ void __launch_bounds__(kThreads, 6)
kpconv_kernel(const float* __restrict__ coord, const float* __restrict__ feat,
              const int* __restrict__ idx, const uint8_t* __restrict__ nmask,
              const float* __restrict__ kp, const float* __restrict__ weight,
              float sigma_r, int B, int N, int S, int P, int Cin, int Cout,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(S, P, Cin, Cout);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const unsigned below = (1u << lane) - 1u;
  const float4* kp_s = reinterpret_cast<const float4*>(smem + L.kp);
  float* a_s = smem + L.a;
  float* wbuf = smem + L.warp0 + warp * L.per_warp;
  float* i_s = wbuf + L.i;

  // the kernel points, and zeros everywhere else: I's padding row and A's
  // padding columns are never written again
  for (int p = tid; p < kMaxP; p += kThreads)
    reinterpret_cast<float4*>(smem + L.kp)[p] =
        p < P ? make_float4(kp[p * 3], kp[p * 3 + 1], kp[p * 3 + 2], 0.f)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = L.a + tid; e < L.total; e += kThreads) smem[e] = 0.f;
  __syncthreads();

  const float thresh = __fmul_ru(sigma_r, sigma_r);  // >= sigma_r^2
  const uintptr_t fa = reinterpret_cast<uintptr_t>(feat);
  const int vec = (Cin & 3) == 0 && (fa & 15) == 0 ? 4 : (Cin & 1) == 0 && (fa & 7) == 0 ? 2 : 1;
  const int M = B * N;
  const int tiles = (M + kTile - 1) / kTile;
  // a lane's part of a point's copies: a slot's coordinates by 3 lanes (10
  // slots an instruction), its feature row by Cin / vec lanes
  const int q3 = lane / 3, a3 = lane - 3 * q3;
  const int chunks = Cin / vec, per_f = 32 / chunks;
  const int qf = lane / chunks, hf = (lane - qf * chunks) * vec;

  // the warp's points in order: tile t's kPointsPerWarp, then tile t + grid
  auto point = [&](int n) {  // the n-th point of this warp
    const int t = blockIdx.x + (n / kPointsPerWarp) * gridDim.x;
    return t * kTile + warp * kPointsPerWarp + n % kPointsPerWarp;
  };
  // a point's table entries (slots lane and lane + 32)
  auto load_table = [&](int m, uint8_t (&nm)[2], int (&id)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = lane + 32 * r;
      const bool ok = m < M && s < S;
      nm[r] = ok ? nmask[(long long)m * S + s] : 0;
      id[r] = ok ? idx[(long long)m * S + s] : 0;
    }
  };
  // the point's valid slots, compacted in slot order by ballot: their
  // feature rows (into F, by parity) and coordinates (into the neighbour
  // list) copied asynchronously, a row by several lanes (3 for the
  // coordinates, C_in / vec for a feature row), so that a copy instruction
  // of the warp touches few lines; F's rows past the count up to the next
  // multiple of 8 zeroed (the product's k-steps read them, against I
  // columns that may hold another point's influences); returns the count
  auto issue_rows = [&](int m, int parity, const uint8_t (&nm)[2], const int (&id)[2]) {
    float* f_s = wbuf + L.f + parity * L.SK * L.FS;
    float* nbr = wbuf + L.nbr + parity * 4 * L.SK;
    int* rows = reinterpret_cast<int*>(wbuf + L.rows);
    const int base = m < M ? (m / N) * N : 0;
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool valid = nm[r] != 0;
      const unsigned ballot = __ballot_sync(kFull, valid);
      if (valid) rows[cnt + __popc(ballot & below)] = base + id[r];
      cnt += __popc(ballot);
    }
    __syncwarp();
    for (int q = q3; q3 < 10 && q < cnt; q += 10)
      cp_async<4>(nbr + 4 * q + a3, coord + (long long)rows[q] * 3 + a3);
    for (int q = qf; qf < per_f && q < cnt; q += per_f) {
      float* dst = f_s + q * L.FS + hf;
      const float* src = feat + (long long)rows[q] * Cin + hf;
      if (vec == 4) cp_async<16>(dst, src);
      else if (vec == 2) cp_async<8>(dst, src);
      else cp_async<4>(dst, src);
    }
    cp_async_commit();
    for (int e = cnt * L.FS + lane; e < ((cnt + 7) & ~7) * L.FS; e += 32) f_s[e] = 0.f;
    return cnt;
  };
  auto center = [&](int m, float (&c)[3]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = m < M ? coord[(long long)m * 3 + a] : 0.f;
  };

  // the pipeline: point n's rows are in flight while point n - 1 computes,
  // point n + 1's table entries while point n's rows are issued
  const int n_points = ((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * kPointsPerWarp;
  uint8_t nm[2];
  int id[2];
  float ctr[3], ctr_next[3];
  load_table(point(0), nm, id);
  int cnt_next = issue_rows(point(0), 0, nm, id);
  center(point(0), ctr_next);
  load_table(point(1), nm, id);

  for (int n = 0; n < n_points; ++n) {
    const int m = point(n), row = n % kPointsPerWarp;
    const int cnt = cnt_next, parity = n & 1;
#pragma unroll
    for (int a = 0; a < 3; ++a) ctr[a] = ctr_next[a];
    cp_async_wait<0>();
    __syncwarp();  // point n's rows have landed; F[parity ^ 1] is free
    if (n + 1 < n_points) {
      cnt_next = issue_rows(point(n + 1), parity ^ 1, nm, id);
      center(point(n + 1), ctr_next);
      load_table(point(n + 2), nm, id);
    }
    const float* f_s = wbuf + L.f + parity * L.SK * L.FS;
    const float4* nbr = reinterpret_cast<const float4*>(wbuf + L.nbr) + parity * L.SK;

    // 1. the pairs' influences into I: the squared distances to every
    // kernel point first (independent), 0 where it is at least thresh, then
    // the root and the division for the few below it, one at a time
    for (int j = lane; j < cnt; j += 32) {
      const float4 q = nbr[j];
      const float rx = __fsub_rn(q.x, ctr[0]), ry = __fsub_rn(q.y, ctr[1]),
                  rz = __fsub_rn(q.z, ctr[2]);
      unsigned near = 0;
#pragma unroll
      for (int p = 0; p < kMaxP; ++p) {
        if (p < P) {
          const float4 k = kp_s[p];
          const float d2 = pcpdf::dist2(rx, ry, rz, k.x, k.y, k.z);
          if (d2 < thresh) near |= 1u << p;
          else i_s[p * L.IS + j] = 0.f;
        }
      }
      while (near != 0) {
        const int p = __ffs(near) - 1;
        near &= near - 1;
        const float4 k = kp_s[p];
        i_s[p * L.IS + j] = influence(pcpdf::dist2(rx, ry, rz, k.x, k.y, k.z), sigma_r);
      }
    }
    __syncwarp();
    // the tile's A rows are free once every warp has finished the last
    // tile's Y = A W
    if (row == 0) __syncthreads();

    // 2. A_i = I_i F_i over the point's valid slots
    {
      float acc[NT1][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kMaxS; k0 += 8) {
        if (k0 < cnt) {
          uint32_t ah[4], al[4];
          pcpdf::split_tf32(i_s[gid * L.IS + k0 + tig], ah[0], al[0]);
          pcpdf::split_tf32(i_s[(gid + 8) * L.IS + k0 + tig], ah[1], al[1]);
          pcpdf::split_tf32(i_s[gid * L.IS + k0 + tig + 4], ah[2], al[2]);
          pcpdf::split_tf32(i_s[(gid + 8) * L.IS + k0 + tig + 4], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt) {
            const int c = nt * 8 + gid;
            const bool on = c < Cin;
            uint32_t bh[2], bl[2];
            pcpdf::split_tf32(on ? f_s[(k0 + tig) * L.FS + c] : 0.f, bh[0], bl[0]);
            pcpdf::split_tf32(on ? f_s[(k0 + tig + 4) * L.FS + c] : 0.f, bh[1], bl[1]);
            pcpdf::mma_split(acc[nt], ah, al, bh, bl);
          }
        }
      }
      float* arow = a_s + (warp * kPointsPerWarp + row) * L.AS;
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = gid + (e >> 1) * 8, c = nt * 8 + 2 * tig + (e & 1);
          if (p < P && c < Cin) arow[p * Cin + c] = acc[nt][e];
        }
    }
    __syncwarp();  // the next point rewrites I
    if (row + 1 < kPointsPerWarp) continue;
    __syncthreads();

    // 3. Y = A W: a warp takes n-tiles warp and warp + 4 of the tile's m16
    // rows; W's fragments from device memory through L1 (W is 17-61 KB and
    // every block reads it)
    const int m_tile = m - row - warp * kPointsPerWarp;  // the tile's first point
    if (warp < L.NT) {
      float acc[2][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < L.PCK; k0 += 8) {
        uint32_t ah[4], al[4];
        pcpdf::split_tf32(a_s[gid * L.AS + k0 + tig], ah[0], al[0]);
        pcpdf::split_tf32(a_s[(gid + 8) * L.AS + k0 + tig], ah[1], al[1]);
        pcpdf::split_tf32(a_s[gid * L.AS + k0 + tig + 4], ah[2], al[2]);
        pcpdf::split_tf32(a_s[(gid + 8) * L.AS + k0 + tig + 4], ah[3], al[3]);
        const int k_lo = k0 + tig, k_hi = k_lo + 4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int nt = warp + 4 * i;
          if (nt < L.NT) {
            const int c = nt * 8 + gid;
            uint32_t bh[2], bl[2];
            pcpdf::split_tf32(k_lo < L.PC && c < Cout ? __ldg(weight + k_lo * Cout + c) : 0.f,
                              bh[0], bl[0]);
            pcpdf::split_tf32(k_hi < L.PC && c < Cout ? __ldg(weight + k_hi * Cout + c) : 0.f,
                              bh[1], bl[1]);
            pcpdf::mma_split(acc[i], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int nt = warp + 4 * i;
        if (nt >= L.NT) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mm = m_tile + gid + (e >> 1) * 8;
          const int c = nt * 8 + 2 * tig + (e & 1);
          if (mm < M && c < Cout) out[(long long)mm * Cout + c] = acc[i][e];
        }
      }
    }
  }
}

template <int NT1>
int launch(const void* coord, const void* feat, const void* idx,
           const void* nmask, const void* kp, const void* weight,
           float sigma_r, int B, int N, int S, int P, int Cin, int Cout,
           void* out, cudaStream_t stream) {
  const size_t smem = (size_t)Layout(S, P, Cin, Cout).total * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = kpconv_kernel<NT1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  const long long tiles = ((long long)B * N + kTile - 1) / kTile;
  const long long room = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(tiles < room ? tiles : room);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(coord), static_cast<const float*>(feat),
      static_cast<const int*>(idx), static_cast<const uint8_t*>(nmask),
      static_cast<const float*>(kp), static_cast<const float*>(weight), sigma_r,
      B, N, S, P, Cin, Cout, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// coord (B, N, 3) f32, feat (B, N, Cin) f32, idx (B, N, S) i32 rows of the
// same sample, nmask (B, N, S) u8, kp (P, 3) f32, weight (P, Cin, Cout) f32
// -> out (B, N, Cout) f32.  S <= 40, P <= 16, Cin <= 16, Cout <= 64.
extern "C" int pcpdf_kpconv(const void* coord, const void* feat,
                            const void* idx, const void* nmask, const void* kp,
                            const void* weight, float sigma_r, int B, int N,
                            int S, int P, int Cin, int Cout, void* out,
                            void* stream) {
  if ((long long)B * N == 0 || Cout == 0) return 0;
  if (S < 1 || S > kMaxS || P < 1 || P > kMaxP || Cin < 1 || Cin > kMaxCin ||
      Cout > kMaxCout)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Cin <= 8 ? launch<1>(coord, feat, idx, nmask, kp, weight, sigma_r, B, N,
                              S, P, Cin, Cout, out, st)
                  : launch<2>(coord, feat, idx, nmask, kp, weight, sigma_r, B, N,
                              S, P, Cin, Cout, out, st);
}
