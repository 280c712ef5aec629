"""K1 on one GPU: an earlier tree's kNN kernel beside this tree's, at the
shapes of ``chip_smoke.py`` phase 3, and the sweeps that set K1's constants.

    python3 tools/knn_compare_torch.py [--parent DIR] [--sweep] [--lanes] [--out FILE]

``--parent DIR``: a tree holding ``pointcloudpdf_tpu_torch/csrc/knn.cu``
(the parent commit unpacked with ``git archive`` into a git-ignored
directory, say).  Its ``knn.cu`` is built alone with nvcc into
``DIR/_knn_build/`` and its ``pcpdf_knn`` is timed beside this tree's
``geometry.knn`` at every phase-3 case (``chip_smoke.knn_cases`` and
``knn_brute_cases``), in turns (parent, this tree, this tree, parent), the
kernels alone (a CUDA graph of calls, ``chip_smoke.graph_ms``) and a call
through the wrapper; the two results must be equal, dist2 and idx bit for
bit (both keep the lower index on ties), or the tool exits non-zero.
``--sweep``: the threshold ``geometry.KNN_PRUNE_MIN_REFS``: both kernels,
the pruned one with its plan, at ref sets of 4,096 to 32,768 points, B = 1,
2 and 16, self k = 16 and an interpolation k = 3 from 4 N queries (the
kernels' device time and the host's time to issue a call); then the pruned
kernel at chunks of 64, 128 and 256 refs at every phase-3 case it takes,
its plan alone and a profile of one call.  ``--lanes``: the brute-force
kernel at every lane count (1 to 32) at phase 3's brute-force cases,
beside the count ``geometry.knn_lanes`` picks.  ``--out`` writes the
numbers as JSON.  Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from _profile_torch import card_line, profile_call  # noqa: E402


def build_parent(tree):
    """nvcc the tree's knn.cu alone (same flags as the port's build)."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    src = os.path.join(tree, "pointcloudpdf_tpu_torch", "csrc", "knn.cu")
    out_dir = os.path.join(tree, "_knn_build")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libknn_parent.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src, "-o", so],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.pcpdf_knn.argtypes = _cuda._SIGNATURES["pcpdf_knn"]
    lib.pcpdf_knn.restype = ctypes.c_int
    return lib


def parent_knn(lib, q, r, k, m):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda

    B, M, _ = q.shape
    idx = torch.empty((B, M, k), dtype=torch.int32, device=q.device)
    d2 = torch.empty((B, M, k), dtype=torch.float32, device=q.device)
    err = lib.pcpdf_knn(q.data_ptr(), r.data_ptr(), m.data_ptr(), B, M, r.shape[1], k,
                        idx.data_ptr(), d2.data_ptr(),
                        ctypes.c_void_p(_cuda.stream_of(q)))
    _cuda.check(err, "parent pcpdf_knn")
    return idx, d2


def compare_parent(lib, cases):
    import torch

    from pointcloudpdf_tpu_torch.ops import geometry

    rows = []
    for name, q, r, k, m, _ in cases:
        q, r, m = q.contiguous(), r.contiguous(), m.to(torch.bool).contiguous()
        pidx, pd2 = parent_knn(lib, q, r, k, m)
        idx, d2 = geometry.knn(q, r, k, m)
        torch.cuda.synchronize()
        same_d2, same_idx = bool(torch.equal(d2, pd2)), bool(torch.equal(idx, pidx))
        iters = 2 if q.shape[1] * r.shape[1] * q.shape[0] > 2 ** 34 else 5
        parent = lambda: parent_knn(lib, q, r, k, m)  # noqa: E731
        new = lambda: geometry.knn(q, r, k, m)  # noqa: E731
        times = [chip_smoke.graph_ms(fn, iters) for fn in (parent, new, new, parent)]
        calls = [chip_smoke.cuda_ms(fn, iters) for fn in (parent, new)]
        kernel = "pruned" if r.shape[1] >= geometry.KNN_PRUNE_MIN_REFS else "brute"
        rows.append({"case": name, "kernel": kernel, "parent_ms": [times[0], times[3]],
                     "new_ms": [times[1], times[2]], "parent_call_ms": calls[0],
                     "new_call_ms": calls[1], "dist2_equal": same_d2, "idx_equal": same_idx,
                     "idx_differ": int((idx != pidx).sum())})
        speedup = (times[0] + times[3]) / (times[1] + times[2])
        print(f"{name:42s} parent {times[0]:8.4f} / {times[3]:8.4f} ms   new "
              f"{times[1]:8.4f} / {times[2]:8.4f} ms ({kernel})   x{speedup:6.2f}   a call "
              f"{calls[0]:.4f} / {calls[1]:.4f}   dist2 equal {same_d2}, idx equal {same_idx}",
              flush=True)
    return rows


def host_ms(fn, calls=10):
    """The host's time to issue one call (no synchronisation inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return t


def sweep(cases):
    import torch

    from pointcloudpdf_tpu_torch.ops import geometry

    rows = []
    print("pruned kernel by chunk (ms; visited share, most chunks a tile):")
    for name, q, r, k, m, same in cases:
        if r.shape[1] < 8192:
            continue
        line = {"case": name}
        for chunk in (64, 128, 256):
            ms = chip_smoke.cuda_ms(
                lambda: geometry.knn_pruned_cuda(q, r, k, m, same, chunk=chunk), 3)
            line[f"R{chunk}"] = [ms, *chip_smoke.visited_share(q, r, k, m, same, chunk)]
        line["plan_ms"] = chip_smoke.cuda_ms(lambda: geometry.knn_plan(q, r, m, same), 3)
        line["host_ms"] = host_ms(lambda: geometry.knn(q, r, k, m))
        line["brute_host_ms"] = host_ms(lambda: geometry.knn_brute_cuda(q, r, k, m))
        rows.append(line)
        print(f"  {name:34s} " + "  ".join(
            f"{key} {v[0]:7.3f} ({v[1]:.4f}, {v[2]})" for key, v in line.items()
            if key.startswith("R")) + f"  plan alone {line['plan_ms']:.3f}; host "
            f"{line['host_ms']:.3f} a call (brute force {line['brute_host_ms']:.3f})")
    # where one call of the first case goes: prep, sort and search on the
    # device, and the host's time for the whole call; how the tiles' work spreads
    name, q, r, k, m, same = cases[0]
    visits = geometry.knn_pruned_cuda(q, r, k, m, same, visits=True)[2].cpu()
    flat = visits.flatten().float()
    print(f"  {name}: chunks a tile visits, percentiles 50/90/99/99.9/max: "
          + " / ".join(f"{float(flat.quantile(x)):.0f}" for x in (0.5, 0.9, 0.99, 0.999))
          + f" / {int(flat.max())}; sum {int(flat.sum())}")
    fn = lambda: geometry.knn(q, r, k, m)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
        torch.cuda.synchronize()
    synced_ms = (time.perf_counter() - t0) * 1e3 / 5
    profile = profile_call(fn, synced_ms, f"K1 {name}", top=12)
    rows.append({"case": f"profile {name}", "host_ms_synced": synced_ms,
                 "device_busy_ms": profile["device_busy_ms"],
                 "top_kernels": profile["top_kernels"]})
    return rows


def threshold_sweep():
    """Both kernels where KNN_PRUNE_MIN_REFS may sit: ref sets of 4,096 to
    32,768 points at B = 1, 2 and 16; self k = 16, and k = 3 from 4 N
    queries (an interpolation); device ms (a CUDA graph of calls, the pruned
    kernel with its plan) and the host's ms to issue a call."""
    import torch

    from pointcloudpdf_tpu_torch.ops import geometry

    rows = []
    rng = np.random.RandomState(7)
    print("both kernels around the threshold (device ms; host ms a call):")
    for n in (4096, 8192, 12288, 16384, 24576, 32768):
        for B in (1, 2, 16):
            cloud = torch.from_numpy(chip_smoke.clustered_cloud(
                rng, B, 4 * n, [4 * n] * B)[0]).cuda()
            r = cloud[:, :n].contiguous()
            m = torch.ones((B, n), dtype=torch.bool, device=r.device)
            for label, q, k, same in (("self k=16", r, 16, True),
                                      ("4N->N k=3", cloud, 3, False)):
                iters = 2 if B * q.shape[1] * n > 2 ** 32 else 5
                brute = lambda: geometry.knn_brute_cuda(q, r, k, m)  # noqa: E731
                pruned = lambda: geometry.knn_pruned_cuda(q, r, k, m, same)  # noqa: E731
                row = {"case": f"{label} N={n} B={B}",
                       "brute_ms": chip_smoke.graph_ms(brute, iters),
                       "pruned_ms": chip_smoke.graph_ms(pruned, iters),
                       "brute_host_ms": host_ms(brute, 5), "pruned_host_ms": host_ms(pruned, 5),
                       "lanes": geometry.knn_lanes(B, q.shape[1])}
                rows.append(row)
                print(f"  {row['case']:24s} brute {row['brute_ms']:8.4f} ({row['lanes']} lanes) "
                      f"pruned {row['pruned_ms']:8.4f}; host {row['brute_host_ms']:.3f} / "
                      f"{row['pruned_host_ms']:.3f}", flush=True)
    return rows


def lanes_sweep(cases):
    """The brute-force kernel at every lane count at phase 3's brute-force
    cases (device ms, a CUDA graph of calls)."""
    from pointcloudpdf_tpu_torch.ops import geometry

    rows = []
    print("brute-force kernel by lanes a query (device ms):")
    for name, q, r, k, m, _ in cases:
        row = {"case": name, "rule": geometry.knn_lanes(q.shape[0], q.shape[1])}
        for lanes in (1, 2, 4, 8, 16, 32):
            row[lanes] = chip_smoke.graph_ms(
                lambda: geometry.knn_brute_cuda(q, r, k, m, lanes), 5)
        rows.append(row)
        best = min((1, 2, 4, 8, 16, 32), key=lambda g: row[g])
        print(f"  {name:42s} rule {row['rule']:2d}, best {best:2d}: " + "  ".join(
            f"{g}: {row[g]:.4f}" for g in (1, 2, 4, 8, 16, 32)), flush=True)
    return rows


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=None, help="tree of the earlier knn.cu")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--lanes", action="store_true")
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = card_line()
    print(card)
    from pointcloudpdf_tpu_torch.ops import _cuda

    _cuda.library()
    dev = torch.device("cuda")
    cases = chip_smoke.knn_cases(dev, np.random.RandomState(chip_smoke.SEED))
    brute_cases = chip_smoke.knn_brute_cases(dev)
    result = {"card": card}
    if args.parent:
        result["parent"] = compare_parent(build_parent(args.parent), cases + brute_cases)
    if args.lanes:
        result["lanes"] = lanes_sweep(brute_cases)
    if args.sweep:
        result["threshold"] = threshold_sweep()
        result["sweep"] = sweep(cases)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    unequal = [row["case"] for row in result.get("parent", [])
               if not (row["dist2_equal"] and row["idx_equal"])]
    if unequal:
        raise SystemExit(f"results differ from the parent's at {unequal}")


if __name__ == "__main__":
    main()
