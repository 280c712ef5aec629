"""K1 on one GPU: an earlier tree's kNN kernel beside this tree's, at the
shapes of ``chip_smoke.py`` phase 3, and the sweeps that set the constants
of the bound-pruned kernel.

    python3 tools/knn_compare_torch.py [--parent DIR] [--sweep] [--out FILE]

``--parent DIR``: a tree holding ``pointcloudpdf_tpu_torch/csrc/knn.cu``
(the parent commit unpacked with ``git archive`` into a git-ignored
directory, say).  Its ``knn.cu`` is built alone with nvcc into
``DIR/_knn_build/`` and its ``pcpdf_knn`` is timed beside this tree's
``geometry.knn`` at every phase-3 case, in turns (parent, this tree, this
tree, parent; CUDA events, 5 calls each after a warm-up); the two results
are compared (dist2 bit for bit, idx exactly: both keep the lower index on
ties).  ``--sweep``: the pruned kernel at chunks of 64, 128 and 256 refs at every
case it takes, its plan alone, a profile of one call, and both kernels at ref sets around
``geometry.KNN_PRUNE_MIN_REFS``.  ``--out`` writes the numbers as JSON.
Needs a CUDA device and nvcc.
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
        same_d2 = bool(torch.equal(d2, pd2))
        idx_diff = int((idx != pidx).sum())
        iters = 2 if q.shape[1] * r.shape[1] * q.shape[0] > 2 ** 34 else 5
        times = [chip_smoke.cuda_ms(lambda: parent_knn(lib, q, r, k, m), iters),
                 chip_smoke.cuda_ms(lambda: geometry.knn(q, r, k, m), iters),
                 chip_smoke.cuda_ms(lambda: geometry.knn(q, r, k, m), iters),
                 chip_smoke.cuda_ms(lambda: parent_knn(lib, q, r, k, m), iters)]
        rows.append({"case": name, "parent_ms": [times[0], times[3]],
                     "new_ms": [times[1], times[2]],
                     "kernel": ("pruned" if r.shape[1] >= geometry.KNN_PRUNE_MIN_REFS
                                else "brute"),
                     "dist2_equal": same_d2, "idx_differ": idx_diff})
        speedup = (times[0] + times[3]) / (times[1] + times[2])
        print(f"{name:34s} parent {times[0]:8.3f} / {times[3]:8.3f} ms   new "
              f"{times[1]:8.3f} / {times[2]:8.3f} ms ({rows[-1]['kernel']})   "
              f"x{speedup:6.2f}   dist2 equal {same_d2}, idx differ {idx_diff}")
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
    print("both kernels around the threshold (ms):")
    rng = np.random.RandomState(7)
    for n in (1024, 2048, 4096, 8192, 16384, 32768):
        coord, mask = chip_smoke.clustered_cloud(rng, 2, n, [n, n - n // 7])
        r = torch.from_numpy(coord).cuda()
        m = torch.from_numpy(mask).cuda()
        # 16384 queries over n refs drawn from the same cloud (ST's sparse
        # keys: a layer's points against a subset of them)
        cloud = torch.from_numpy(chip_smoke.clustered_cloud(
            rng, 2, max(n, 16384), [max(n, 16384)] * 2)[0]).cuda()
        q16, r16 = cloud[:, :16384].contiguous(), cloud[:, :n].contiguous()
        m16 = torch.ones(r16.shape[:2], dtype=torch.bool, device=r16.device)
        for label, q, r, m, k, same in (("self k=16", r, r, m, 16, True),
                                        ("self k=32", r, r, m, 32, True),
                                        ("16384->N k=16", q16, r16, m16, 16, False)):
            brute = chip_smoke.cuda_ms(lambda: geometry.knn_brute_cuda(q, r, k, m), 5)
            pruned = chip_smoke.cuda_ms(
                lambda: geometry.knn_pruned_cuda(q, r, k, m, same), 5)
            rows.append({"case": f"{label} N={n}", "brute_ms": brute, "pruned_ms": pruned})
            print(f"  {label:14s} N={n:6d}: brute {brute:7.3f}  pruned {pruned:7.3f}")
    return rows


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=None, help="tree of the earlier knn.cu")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = card_line()
    print(card)
    from pointcloudpdf_tpu_torch.ops import _cuda

    _cuda.library()
    cases = chip_smoke.knn_cases(torch.device("cuda"), np.random.RandomState(chip_smoke.SEED))
    result = {"card": card}
    if args.parent:
        result["parent"] = compare_parent(build_parent(args.parent), cases)
    if args.sweep:
        result["sweep"] = sweep(cases)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
