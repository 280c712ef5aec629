"""Where a warp of K6 spends its cycles, on one GPU.

    python3 tools/kpconv_clocks.py [--ablate] [--blocks] [--out FILE]

Copies ``pointcloudpdf_tpu_torch/csrc/kpconv.cu`` into
``pointcloudpdf_tpu_torch/_build/kpconv_clocks/`` with clock64() counters
added (lane 0 of every warp, summed over the launch): a point's wait for
its rows, the issue of the next point's copies, its influences, the wait at
the barrier before a tile's first A row, its product I F, the wait at the
barrier before Y = A W and that product; builds the copy
alone with nvcc and runs it at ``chip_smoke.KPCONV_SHAPES`` over a table
built as ``chip_smoke.py`` phase 3 builds it: the mean cycles a point of
each part and a tile's of each barrier wait and of the product with W,
beside the time of the copy built without counters (a CUDA graph of
calls), and the share of (valid pair, kernel point) that lie within
sigma_r (those computed in full).  ``--ablate`` also times copies with one
part taken out (the influences, or only their roots and divisions, either
product, the gathers), whose outputs are wrong: the time each part adds;
``--blocks`` copies whose grid holds 1-5 blocks an SM: the time against
the warps in flight.  The counters change the kernel's code, so their
times are not the kernel's: they say which part dominates.  Fails if the
kernel's source no longer holds a place a patch goes.  Needs a CUDA device
and nvcc.
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

# counters, each summed over the warps: 0 the wait for the point's rows, 1
# issuing the next point's copies, 2 the influences, 3 the wait for the A
# rows, 4 the product I F, 5 points; 6 the wait for Y = A W, 7 that
# product, 8 warp-tiles
POINT = ("wait rows", "issue next", "influences", "wait A rows", "product I F")
TILE = ("wait A W", "product A W")
PATCHES = (
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_clocks[16];\n"),
    ("    cp_async_wait<0>();\n    __syncwarp();  // point n's rows have landed; F[parity ^ 1] is free\n",
     "    const long long c0 = clock64();\n    cp_async_wait<0>();\n"
     "    __syncwarp();  // point n's rows have landed; F[parity ^ 1] is free\n"
     "    const long long c1 = clock64();\n"),
    ("    const float* f_s = wbuf + L.f + parity * L.SK * L.FS;\n",
     "    const long long c2 = clock64();\n    const float* f_s = wbuf + L.f + parity * L.SK * L.FS;\n"),
    ("    // the tile's A rows are free once",
     "    const long long c3 = clock64();\n    // the tile's A rows are free once"),
    ("    if (row == 0) __syncthreads();\n",
     "    if (row == 0) __syncthreads();\n    const long long c4 = clock64();\n"),
    ("    __syncwarp();  // the next point rewrites I\n",
     "    __syncwarp();  // the next point rewrites I\n"
     "    if (lane == 0) {\n"
     "      atomicAdd(&g_clocks[0], (unsigned long long)(c1 - c0));\n"
     "      atomicAdd(&g_clocks[1], (unsigned long long)(c2 - c1));\n"
     "      atomicAdd(&g_clocks[2], (unsigned long long)(c3 - c2));\n"
     "      atomicAdd(&g_clocks[3], (unsigned long long)(c4 - c3));\n"
     "      atomicAdd(&g_clocks[4], (unsigned long long)(clock64() - c4));\n"
     "      atomicAdd(&g_clocks[5], 1ull);\n"
     "    }\n"),
    ("    __syncthreads();\n\n    // 3. Y = A W",
     "    const long long c5 = clock64();\n    __syncthreads();\n    const long long c6 = clock64();\n\n"
     "    // 3. Y = A W"),
    ("          if (mm < M && c < Cout) out[(long long)mm * Cout + c] = acc[i][e];\n"
     "        }\n      }\n    }\n",
     "          if (mm < M && c < Cout) out[(long long)mm * Cout + c] = acc[i][e];\n"
     "        }\n      }\n    }\n"
     "    if (lane == 0) {\n"
     "      atomicAdd(&g_clocks[6], (unsigned long long)(c6 - c5));\n"
     "      atomicAdd(&g_clocks[7], (unsigned long long)(clock64() - c6));\n"
     "      atomicAdd(&g_clocks[8], 1ull);\n"
     "    }\n"),
)
# --ablate: copies with one part of the work taken out (their outputs are
# wrong; only their times are read): the time a part adds
ABLATIONS = (
    ("no influences", "    for (int j = lane; j < cnt; j += 32) {",
     "    for (int j = lane; j < 0; j += 32) {"),
    ("no near influences", "      while (near != 0) {", "      near = 0;\n      while (near != 0) {"),
    ("no product I F", "        if (k0 < cnt) {", "        if (k0 < 0) {"),
    ("no product A W", "    if (warp < L.NT) {", "    if (warp < 0) {"),
    ("no gathers", "    for (int q = q3; q3 < 10 && q < cnt; q += 10)",
     "    for (int q = q3; q3 < 0 && q < cnt; q += 10)"),
    ("no gathers", "    for (int q = qf; qf < per_f && q < cnt; q += per_f) {",
     "    for (int q = qf; qf < 0 && q < cnt; q += per_f) {"),
)
# --blocks: copies whose grid holds k blocks an SM (the kernel takes as
# many as fit): the time against the warps in flight
ROOM = "  const long long room = (long long)sms * (per_sm > 0 ? per_sm : 1);"
BLOCKS = tuple((f"{k} blocks an SM", ROOM, f"  const long long room = (long long)sms * {k};")
               for k in (1, 2, 3, 4, 5))
READERS = """
extern "C" int clocks_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
}

extern "C" int clocks_reset() {
  unsigned long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
}
"""


def build(counters, ablation=None):
    """A copy of kpconv.cu built alone, with the counters (``counters``)
    or without, or with the parts of ``ablation`` taken out; fails if the
    source no longer holds a place a patch goes."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda.CSRC, "kpconv.cu")) as f:
        src = f.read()
    patches = [(old, new) for name, old, new in ABLATIONS + BLOCKS if name == ablation]
    for old, new in (PATCHES if counters else ()) + tuple(patches):
        if src.count(old) != 1:
            raise SystemExit(f"csrc/kpconv.cu changed: no one place for the patch at\n{old}")
        src = src.replace(old, new)
    work = os.path.join(_cuda.BUILD_DIR, "kpconv_clocks")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(_cuda.CSRC, "common.cuh")) as f, \
            open(os.path.join(work, "common.cuh"), "w") as g:
        g.write(f.read())
    stem = ("kpconv_clocks" if counters else "kpconv") + (
        "_" + ablation.replace(" ", "_") if ablation else "")
    with open(os.path.join(work, stem + ".cu"), "w") as f:
        f.write(src + (READERS if counters else ""))
    so = os.path.join(work, f"lib{stem}.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
                           os.path.join(work, stem + ".cu"), "-o", so],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit("nvcc failed on the copy:\n" + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    lib.pcpdf_kpconv.argtypes = _cuda._SIGNATURES["pcpdf_kpconv"]
    lib.pcpdf_kpconv.restype = ctypes.c_int
    if counters:
        lib.clocks_read.argtypes = [ctypes.c_void_p]
    report = [line.strip() for line in proc.stdout.splitlines() + proc.stderr.splitlines()
              if "registers" in line or "spill" in line]
    return lib, report


def near_share(coord, idx, nmask, points, sigma_r):
    """The share of (valid pair, kernel point) whose squared distance lies
    below the smallest float >= sigma_r^2: those the kernel computes in
    full."""
    import torch

    from pointcloudpdf_tpu_torch.ops.geometry import gather_rows

    thresh = np.float32(np.float64(np.float32(sigma_r)) ** 2)
    if float(thresh) < np.float64(np.float32(sigma_r)) ** 2:
        thresh = np.nextafter(thresh, np.float32(np.inf))
    near = total = 0
    for b in range(coord.shape[0]):
        rel = gather_rows(coord[b:b + 1], idx[b:b + 1]) - coord[b:b + 1, :, None, :]
        d = rel[..., None, :] - points
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        ok = nmask[b:b + 1, ..., None].expand_as(d2)
        near += int(((d2 < float(thresh)) & ok).sum())
        total += int(ok.sum())
        del rel, d, d2, ok
        torch.cuda.empty_cache()
    return near / max(total, 1)


def main():
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    parser.add_argument("--ablate", action="store_true",
                        help="also time copies with one part of the work taken out")
    parser.add_argument("--blocks", action="store_true",
                        help="also time copies held to 1-5 blocks an SM")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    plain, report = build(False)
    counted, _ = build(True)
    variants = ((ABLATIONS if args.ablate else ()) + (BLOCKS if args.blocks else ()))
    ablated = {name: build(False, name)[0] for name in dict.fromkeys(n for n, _, _ in variants)}
    print("; ".join(report), flush=True)
    rng = np.random.RandomState(chip_smoke.SEED)
    B, N, S = 2, chip_smoke.N_MAIN, 34
    coord, mask, idx, nmask, points, sigma_r = chip_smoke.kpconv_table(dev, rng, B, N, S)
    share = near_share(coord, idx, nmask, points, sigma_r)
    print(f"valid pairs {int(nmask.sum())}, {float(nmask.sum()) / (B * N):.1f} a point; "
          f"(pair, kernel point) within sigma_r: {share:.4f}", flush=True)
    P = points.shape[0]
    idx32 = idx.to(torch.int32).contiguous()
    rows = []
    for c_in, c_out in chip_smoke.KPCONV_SHAPES:
        feat, weight = chip_smoke.kpconv_weights(dev, rng, B, N, P, c_in, c_out)
        out = torch.empty((B, N, c_out), dtype=torch.float32, device=dev)

        def call(lib):
            def run():
                _cuda.check(lib.pcpdf_kpconv(
                    coord.data_ptr(), feat.data_ptr(), idx32.data_ptr(), nmask.data_ptr(),
                    points.data_ptr(), weight.data_ptr(), sigma_r, B, N, S, P, c_in, c_out,
                    out.data_ptr(), ctypes.c_void_p(_cuda.stream_of(feat))), "pcpdf_kpconv")
            return run

        ms = chip_smoke.graph_ms(call(plain), 10)
        ablated_ms = {name: chip_smoke.graph_ms(call(lib), 10) for name, lib in ablated.items()}
        call(counted)()  # warm-up
        counted.clocks_reset()
        call(counted)()
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * 16)()
        counted.clocks_read(ctypes.byref(raw))
        c = list(raw)
        points_n, tiles_n = max(c[5], 1), max(c[8], 1)
        row = {name: c[i] / points_n for i, name in enumerate(POINT)}
        row.update({name: c[6 + i] / tiles_n for i, name in enumerate(TILE)})
        row.update(case=f"{c_in}->{c_out} N={N} S={S} P={P}", ms=ms, warp_points=c[5],
                   warp_tiles=c[8], near_share=share, ablated_ms=ablated_ms)
        rows.append(row)
        print(f"{row['case']:28s} {ms:.4f} ms; cycles a point: "
              + ", ".join(f"{n} {row[n]:.0f}" for n in POINT)
              + "; a warp's a tile: " + ", ".join(f"{n} {row[n]:.0f}" for n in TILE)
              + "".join(f"; {n} {t:.4f} ms" for n, t in ablated_ms.items()), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
