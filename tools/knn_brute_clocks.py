"""Where a warp of K1's brute-force kernel spends its cycles, on one GPU.

    python3 tools/knn_brute_clocks.py [--lanes 0 1 8] [--out FILE]

Copies ``pointcloudpdf_tpu_torch/csrc/knn.cu`` into
``pointcloudpdf_tpu_torch/_build/knn_clocks/`` with clock64() counters
added around the staging of the refs (compaction and padding), the scan,
the flushes of the queues inside it and the final merge, builds the copy
alone with nvcc, and runs it at ``chip_smoke.py`` phase 3's brute-force
cases and its ST sparse-key case: per warp, the mean cycles of each part,
the flushes, the entries a flush inserts and the insertions a lane.
``--lanes``: the lane counts to run (0: the host's rule).  The counters
change the kernel's code, so its times are not the kernel's: they say
which part dominates.  Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from _profile_torch import card_line  # noqa: E402

# counters: 0 staging, 1 scan, 2 flushes inside it, 3 flush count, 4 entries
# flushed, 5 merge, 6 steps, 7 warps (each summed over warps)
PATCHES = (
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_clocks[8];\n"),
    ("""    if (__any_sync(kFull, qn > kQueue - kUnroll)) {
      flush<K_MAX>(queue, qn, tau, key);
      tau = group_gate<K_MAX>(key, m, r, G, l);
      gate = next_up(fminf(key_dist(key[K_MAX - 1]), tau));
    }""",
     """    if (__any_sync(kFull, qn > kQueue - kUnroll)) {
      const long long f0 = clock64();
      const int entries = __reduce_add_sync(kFull, qn);
      flush<K_MAX>(queue, qn, tau, key);
      tau = group_gate<K_MAX>(key, m, r, G, l);
      gate = next_up(fminf(key_dist(key[K_MAX - 1]), tau));
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(&g_clocks[2], (unsigned long long)(clock64() - f0));
        atomicAdd(&g_clocks[3], 1ull);
        atomicAdd(&g_clocks[4], (unsigned long long)entries);
      }
    }"""),
    ("""  if (N <= kDirectRefs) {
    const int n = compact_refs(rb, mb, 0, N, stage, 0, sums);
    pad_refs(stage, n, G);
    __syncthreads();
    scan_refs<K_MAX>(stage, n, l, G, m, r, home_q, M, qx, qy, qz, key, tau, queue, qn);
  } else {""",
     """  if (N <= kDirectRefs) {
    const long long c0 = clock64();
    const int n = compact_refs(rb, mb, 0, N, stage, 0, sums);
    pad_refs(stage, n, G);
    __syncthreads();
    const long long c1 = clock64();
    scan_refs<K_MAX>(stage, n, l, G, m, r, home_q, M, qx, qy, qz, key, tau, queue, qn);
    const long long c2 = clock64();
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&g_clocks[0], (unsigned long long)(c1 - c0));
      atomicAdd(&g_clocks[1], (unsigned long long)(c2 - c1));
      atomicAdd(&g_clocks[6], (unsigned long long)((n + kUnroll * G - 1) / (kUnroll * G)));
      atomicAdd(&g_clocks[7], 1ull);
    }
  } else {"""),
    ("""  // k rounds of the group's least head; real entries have distinct""",
     """  const long long m0 = clock64();
  // k rounds of the group's least head; real entries have distinct"""),
    ("""      key[K_MAX - 1] = kEmptyKey;
    }
  }
}""",
     """      key[K_MAX - 1] = kEmptyKey;
    }
  }
  if ((threadIdx.x & 31) == 0) atomicAdd(&g_clocks[5], (unsigned long long)(clock64() - m0));
}"""),
    ("""extern "C" int pcpdf_knn_lanes(int B, int M) { return brute_lanes(B, M); }""",
     """extern "C" int pcpdf_knn_lanes(int B, int M) { return brute_lanes(B, M); }

extern "C" int clocks_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
}

extern "C" int clocks_reset() {
  unsigned long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
}"""),
)


def build():
    """The instrumented copy of knn.cu, built alone; fails if the source no
    longer holds a place a counter goes."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda.CSRC, "knn.cu")) as f:
        src = f.read()
    for old, new in PATCHES:
        if old not in src:
            raise SystemExit(f"csrc/knn.cu changed: no place for the counter at\n{old}")
        src = src.replace(old, new, 1)
    work = os.path.join(_cuda.BUILD_DIR, "knn_clocks")
    os.makedirs(work, exist_ok=True)
    for name in ("common.cuh",):
        with open(os.path.join(_cuda.CSRC, name)) as f, open(os.path.join(work, name), "w") as g:
            g.write(f.read())
    with open(os.path.join(work, "knn.cu"), "w") as f:
        f.write(src)
    so = os.path.join(work, "libknn_clocks.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", os.path.join(work, "knn.cu"),
                    "-o", so], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.pcpdf_knn_brute.argtypes = _cuda._SIGNATURES["pcpdf_knn_brute"]
    lib.pcpdf_knn_brute.restype = ctypes.c_int
    lib.clocks_read.argtypes = [ctypes.c_void_p]
    return lib


def clocks(lib, q, r, k, m, lanes):
    """Per-warp means of one launch's counters."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda

    q, r, m = q.contiguous(), r.contiguous(), m.to(torch.bool).contiguous()
    B, M = q.shape[:2]
    idx = torch.empty((B, M, k), dtype=torch.int32, device=q.device)
    d2 = torch.empty((B, M, k), dtype=torch.float32, device=q.device)
    lib.clocks_reset()
    _cuda.check(lib.pcpdf_knn_brute(q.data_ptr(), r.data_ptr(), m.data_ptr(), B, M, r.shape[1],
                                    k, lanes, idx.data_ptr(), d2.data_ptr(),
                                    ctypes.c_void_p(_cuda.stream_of(q))), "pcpdf_knn_brute")
    torch.cuda.synchronize()
    raw = (ctypes.c_ulonglong * 8)()
    lib.clocks_read(ctypes.byref(raw))
    c = list(raw)
    warps = max(c[7], 1)
    return {"staging": c[0] / warps, "scan": c[1] / warps, "flush": c[2] / warps,
            "flushes": c[3] / warps, "entries_a_flush": c[4] / max(c[3], 1),
            "insertions_a_lane": c[4] / warps / 32, "merge": c[5] / warps,
            "steps": c[6] / warps, "warps": c[7]}


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--lanes", type=int, nargs="+", default=[0])
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = card_line()
    print(card)
    from pointcloudpdf_tpu_torch.ops import geometry

    lib = build()
    dev = torch.device("cuda")
    cases = chip_smoke.knn_brute_cases(dev)
    cases += [c for c in chip_smoke.knn_cases(dev, np.random.RandomState(chip_smoke.SEED))
              if c[2].shape[1] < geometry.KNN_PRUNE_MIN_REFS]
    rows = []
    for name, q, r, k, m, _ in cases:
        for lanes in args.lanes:
            row = clocks(lib, q, r, k, m, lanes)
            row.update(case=name, lanes=lanes or geometry.knn_lanes(q.shape[0], q.shape[1]))
            rows.append(row)
            print(f"{name:42s} G={row['lanes']:2d} cycles a warp: staging {row['staging']:8.0f} "
                  f"scan {row['scan']:9.0f} (flushes {row['flush']:9.0f} in {row['flushes']:5.1f}, "
                  f"{row['entries_a_flush']:6.1f} entries each, {row['insertions_a_lane']:6.1f} "
                  f"insertions a lane) merge {row['merge']:7.0f}; {row['steps']:.0f} steps, "
                  f"{row['warps']} warps", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
