"""Where a block of K5 spends its cycles, on one GPU.

    python3 tools/st_attention_clocks.py [--out FILE]

Copies ``pointcloudpdf_tpu_torch/csrc/st_attention.cu`` into
``pointcloudpdf_tpu_torch/_build/st_clocks/`` with clock64() counters
added at the barriers of a tile (thread 0: the q-term product, the
per-query phase, the value product, the output) and inside the per-query
phase (lane 0 of each warp: the logits, the softmax, the histogram, sum_j
p_j v_j, the next tile's lists), builds the copy alone with nvcc, and runs
it at ``chip_smoke.ST_CASES``: the mean cycles a tile of each barrier phase
and a warp's of each per-query part, beside the time of the copy built
without them (a CUDA graph of calls).  The counters change the kernel's
code, so their times are not the kernel's: they say which part dominates.
Fails if the kernel's source no longer holds a place a counter goes.
Needs a CUDA device and nvcc.
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

# counters, each summed: 0-3 the barrier phases of a tile (thread 0), 4-8
# the parts of a warp's per-query phase (lane 0), 9 tiles, 10 warp-tiles
BLOCK = ("q-term product", "per-query phase", "value product", "output")
WARP = ("logits", "softmax", "histogram", "p v", "next lists")
PATCHES = (
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_clocks[16];\n"),
    ("    const int m0 = tile * TQ, next = tile + gridDim.x;\n",
     "    const int m0 = tile * TQ, next = tile + gridDim.x;\n    const long long c0 = clock64();\n"),
    ("    __syncthreads();\n\n    // --- this warp's queries: logits, softmax, histogram, sum_j p_j v_j,\n",
     "    __syncthreads();\n    const long long c1 = clock64();\n    long long w0, w1, w2, w3, w4;\n\n"
     "    // --- this warp's queries: logits, softmax, histogram, sum_j p_j v_j,\n"),
    ("      // logits, two lanes a pair",
     "      w0 = clock64();\n      // logits, two lanes a pair"),
    ("      __syncwarp();\n      // the softmax of each",
     "      __syncwarp();\n      w1 = clock64();\n      // the softmax of each"),
    ("      if (tv != nullptr) {\n        // the histograms",
     "      w2 = clock64();\n      if (tv != nullptr) {\n        // the histograms"),
    ("      __syncwarp();\n      // sum_j p_j v_j",
     "      __syncwarp();\n      w3 = clock64();\n      // sum_j p_j v_j"),
    ("        sO[((lane >> 4) * TQ + qj) * 16 + (lane & 15)] = (acc[0] + acc[1]) + (acc[2] + acc[3]);\n"
     "      }\n    }\n",
     "        sO[((lane >> 4) * TQ + qj) * 16 + (lane & 15)] = (acc[0] + acc[1]) + (acc[2] + acc[3]);\n"
     "      }\n    }\n    w4 = clock64();\n"),
    ("    if (!(warp & 1) && next < tiles) build_lists(next, buf ^ 1);\n    __syncthreads();\n",
     "    if (!(warp & 1) && next < tiles) build_lists(next, buf ^ 1);\n"
     "    if (lane == 0) {\n"
     "      const long long w5 = clock64();\n"
     "      atomicAdd(&g_clocks[4], (unsigned long long)(w1 - w0));\n"
     "      atomicAdd(&g_clocks[5], (unsigned long long)(w2 - w1));\n"
     "      atomicAdd(&g_clocks[6], (unsigned long long)(w3 - w2));\n"
     "      atomicAdd(&g_clocks[7], (unsigned long long)(w4 - w3));\n"
     "      atomicAdd(&g_clocks[8], (unsigned long long)((w0 - c1) + (w5 - w4)));\n"
     "      atomicAdd(&g_clocks[10], 1ull);\n"
     "    }\n"
     "    __syncthreads();\n    const long long c2 = clock64();\n"),
    ("    __syncthreads();\n\n    // --- out = ",
     "    __syncthreads();\n    const long long c3 = clock64();\n\n    // --- out = "),
    ("      *reinterpret_cast<float4*>(out + (long long)m * C + hoff + h * 16 + 4 * i) = r;\n    }\n",
     "      *reinterpret_cast<float4*>(out + (long long)m * C + hoff + h * 16 + 4 * i) = r;\n    }\n"
     "    if (tid == 0) {\n"
     "      const long long c4 = clock64();\n"
     "      atomicAdd(&g_clocks[0], (unsigned long long)(c1 - c0));\n"
     "      atomicAdd(&g_clocks[1], (unsigned long long)(c2 - c1));\n"
     "      atomicAdd(&g_clocks[2], (unsigned long long)(c3 - c2));\n"
     "      atomicAdd(&g_clocks[3], (unsigned long long)(c4 - c3));\n"
     "      atomicAdd(&g_clocks[9], 1ull);\n"
     "    }\n"),
)
READERS = """
extern "C" int clocks_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
}

extern "C" int clocks_reset() {
  unsigned long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
}
"""


def build(counters):
    """A copy of st_attention.cu built alone, with the counters
    (``counters``) or without; fails if the source no longer holds a place
    a counter goes."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda.CSRC, "st_attention.cu")) as f:
        src = f.read()
    for old, new in PATCHES if counters else ():
        if src.count(old) != 1:
            raise SystemExit(f"csrc/st_attention.cu changed: no one place for the counter at\n{old}")
        src = src.replace(old, new)
    work = os.path.join(_cuda.BUILD_DIR, "st_clocks")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(_cuda.CSRC, "common.cuh")) as f, \
            open(os.path.join(work, "common.cuh"), "w") as g:
        g.write(f.read())
    stem = "st_attention_clocks" if counters else "st_attention"
    with open(os.path.join(work, stem + ".cu"), "w") as f:
        f.write(src + (READERS if counters else ""))
    so = os.path.join(work, f"lib{stem}.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
                           os.path.join(work, stem + ".cu"), "-o", so],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit("nvcc failed on the copy:\n" + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    lib.pcpdf_st_attention.argtypes = _cuda._SIGNATURES["pcpdf_st_attention"]
    lib.pcpdf_st_attention.restype = ctypes.c_int
    if counters:
        lib.clocks_read.argtypes = [ctypes.c_void_p]
    report = [line.strip() for line in proc.stdout.splitlines() + proc.stderr.splitlines()
              if "registers" in line or "spill" in line]
    return lib, report


def call(lib, args):
    """The launch of ``lib``'s kernel on the wrapper's arguments."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import st_attention as sa

    q, k, v, coord, key_idx, key_mask, tq, tk, tv, _, window, quant, num_bins = args
    B, N, C = q.shape
    key_idx = key_idx.to(torch.int32).contiguous()
    key_mask = key_mask.contiguous()
    out = torch.empty_like(q)

    def run():
        _cuda.check(lib.pcpdf_st_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), coord.data_ptr(), key_idx.data_ptr(),
            key_mask.data_ptr(), *[None if t is None else t.data_ptr() for t in (tq, tk, tv)],
            sa.HEAD_DIM ** -0.5, 2 * window, 1e-4, quant, B, N, C, key_idx.shape[-1], num_bins,
            out.data_ptr(), ctypes.c_void_p(_cuda.stream_of(q))), "pcpdf_st_attention")
        return out
    return run


def clocks(lib, args):
    """Mean cycles of one launch: a tile's barrier phases, a warp's parts
    of the per-query phase."""
    import torch

    lib.clocks_reset()
    call(lib, args)()
    torch.cuda.synchronize()
    raw = (ctypes.c_ulonglong * 16)()
    lib.clocks_read(ctypes.byref(raw))
    c = list(raw)
    tiles, wt = max(c[9], 1), max(c[10], 1)
    row = {name: c[i] / tiles for i, name in enumerate(BLOCK)}
    row.update({name: c[4 + i] / wt for i, name in enumerate(WARP)})
    row.update(tiles=c[9], warp_tiles=c[10])
    return row


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    plain, report = build(False)
    counted, _ = build(True)
    print("; ".join(report), flush=True)
    rng = np.random.RandomState(chip_smoke.SEED)
    rows = []
    for case in chip_smoke.ST_CASES:
        name, args_ = chip_smoke.st_attention_case(dev, rng, case)
        with torch.inference_mode():
            ms = chip_smoke.graph_ms(call(plain, args_), 10)
            clocks(counted, args_)  # warm-up
            row = clocks(counted, args_)
        row.update(case=name, ms=ms)
        rows.append(row)
        print(f"{name:44s} {ms:.4f} ms; cycles a tile: "
              + ", ".join(f"{n} {row[n]:.0f}" for n in BLOCK)
              + "; a warp's: " + ", ".join(f"{n} {row[n]:.0f}" for n in WARP)
              + f"; {row['tiles']} tiles", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
