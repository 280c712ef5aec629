"""K6 on one GPU: an earlier tree's KPConv kernel beside this tree's, at the
stem shapes of ``chip_smoke.py`` phase 3.

    python3 tools/kpconv_compare_torch.py --parent DIR [--out FILE]

``--parent DIR``: a tree holding ``pointcloudpdf_tpu_torch/csrc/`` (the
parent commit unpacked with ``git archive`` into a git-ignored directory,
say).  Its ``kpconv.cu`` is built alone with nvcc into ``DIR/_kpconv_build/``
and its ``pcpdf_kpconv`` is timed beside this tree's on the same inputs, in
turns (parent, this tree, this tree, parent): the kernels alone, from a
CUDA graph of calls (``chip_smoke.graph_ms``), at every shape of
``chip_smoke.KPCONV_SHAPES`` (B = 2, N = 65,536, S = 34, P = 15: the S3DIS
ST stem's 6 -> 48 and 12 -> 12) over phase 3's neighbour table, the plain
version once beside them.  The two outputs are held against each other,
relative to the parent's max magnitude; the tool exits non-zero where they
differ by more than ``chip_smoke.TOL_K6``.  ``bound_ms`` is
``chip_smoke.kpconv_bound``'s.  ``--out`` writes the numbers as JSON, with
the card's ``nvidia-smi`` name and power limit.  Needs a CUDA device and
nvcc.
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


def build_parent(tree):
    """nvcc the tree's kpconv.cu alone (same flags as the port's build)."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    src = os.path.join(tree, "pointcloudpdf_tpu_torch", "csrc", "kpconv.cu")
    out_dir = os.path.join(tree, "_kpconv_build")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libkpconv_parent.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the parent's kernel:\n" + proc.stdout + proc.stderr)
    fn = ctypes.CDLL(so).pcpdf_kpconv
    fn.argtypes = _cuda._SIGNATURES["pcpdf_kpconv"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, coord, feat, idx, nmask, points, weight, sigma_r):
    """A call of ``fn`` (a ``pcpdf_kpconv``) into an output of its own."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda

    B, N, c_in = feat.shape
    S, (P, _, c_out) = idx.shape[-1], weight.shape
    idx = idx.to(torch.int32).contiguous()
    nmask = nmask.contiguous()
    out = torch.empty((B, N, c_out), dtype=torch.float32, device=feat.device)

    def run():
        err = fn(coord.data_ptr(), feat.data_ptr(), idx.data_ptr(), nmask.data_ptr(),
                 points.data_ptr(), weight.data_ptr(), sigma_r, B, N, S, P, c_in, c_out,
                 out.data_ptr(), ctypes.c_void_p(_cuda.stream_of(feat)))
        _cuda.check(err, "pcpdf_kpconv")
        return out
    return run


def compare(parent_fn, rng):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import kpconv as kp

    dev = torch.device("cuda")
    B, N, S = 2, chip_smoke.N_MAIN, 34
    coord, mask, idx, nmask, points, sigma_r = chip_smoke.kpconv_table(dev, rng, B, N, S)
    P = points.shape[0]
    new_fn = _cuda.library().pcpdf_kpconv
    rows, worst = [], 0.0
    for c_in, c_out in chip_smoke.KPCONV_SHAPES:
        feat, weight = chip_smoke.kpconv_weights(dev, rng, B, N, P, c_in, c_out)
        args = (coord, feat, idx, nmask, points, weight, sigma_r)
        with torch.inference_mode():
            old_run, new_run = launcher(parent_fn, *args), launcher(new_fn, *args)
            old = old_run().clone()
            new = new_run().clone()
            torch.cuda.synchronize()
            err = float((new - old).abs().max()) / max(float(old.abs().max()), 1e-30)
            worst = max(worst, err)
            times = [chip_smoke.graph_ms(f, 10) for f in (old_run, new_run, new_run, old_run)]
            with _cuda.plain_versions():
                plain_ms = chip_smoke.cuda_ms(lambda: kp.kpconv(*args), 3)
        n_bytes, n_flops, bound_ms, bound_by, pairs = chip_smoke.kpconv_bound(
            nmask, B, N, S, P, c_in, c_out)
        name = f"{c_in}->{c_out} N={N} S={S} P={P}"
        rows.append({"case": name, "c_in": c_in, "c_out": c_out, "pairs": pairs,
                     "parent_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "rel_err": err})
        speedup = (times[0] + times[3]) / (times[1] + times[2])
        print(f"{name:28s} parent {times[0]:7.4f} / {times[3]:7.4f} ms   new "
              f"{times[1]:7.4f} / {times[2]:7.4f} ms   x{speedup:6.2f}   plain "
              f"{plain_ms:8.3f}   bound {bound_ms:.4f} ({bound_by})   rel err {err:.2e}",
              flush=True)
    return rows, worst


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True, help="tree of the earlier kernel")
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = card_line()
    print(card)
    rows, worst = compare(build_parent(args.parent), np.random.RandomState(chip_smoke.SEED))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)
    if worst > chip_smoke.TOL_K6:
        raise SystemExit(f"the kernels differ by {worst:.3e} of max |parent|")


if __name__ == "__main__":
    main()
