"""K5 on one GPU: an earlier tree's kernel beside this tree's, at the K5
shapes of ``chip_smoke.py`` phase 3.

    python3 tools/st_attention_compare_torch.py --parent DIR [--out FILE]

``--parent DIR``: a tree holding ``pointcloudpdf_tpu_torch/csrc/`` (the
parent commit unpacked with ``git archive`` into a git-ignored directory,
say).  Its ``st_attention.cu`` is built alone with nvcc into
``DIR/_st_build/`` and its ``pcpdf_st_attention`` is timed beside this
tree's on the same inputs, in turns (parent, this tree, this tree,
parent): the kernels alone, from a CUDA graph of calls
(``chip_smoke.graph_ms``), at every case of ``chip_smoke.ST_CASES`` (B = 2;
the three layer shapes of the shipped S3DIS ST config, the module's
defaults and K = 64), the plain version once beside them.  The two outputs
are held against each other, relative to the parent's max magnitude; the
tool exits non-zero where they differ by more than ``chip_smoke.TOL_K5``.
``bound_ms`` is ``chip_smoke.st_attention_bound``'s.  ``--out`` writes the
numbers as JSON, with the card's ``nvidia-smi`` name and power limit.
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


def build_parent(tree):
    """nvcc the tree's st_attention.cu alone (same flags as the port's
    build)."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    src = os.path.join(tree, "pointcloudpdf_tpu_torch", "csrc", "st_attention.cu")
    out_dir = os.path.join(tree, "_st_build")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libst_parent.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the parent's kernel:\n" + proc.stdout + proc.stderr)
    fn = ctypes.CDLL(so).pcpdf_st_attention
    fn.argtypes = _cuda._SIGNATURES["pcpdf_st_attention"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, args):
    """A call of ``fn`` (a ``pcpdf_st_attention``) on the wrapper's
    arguments, into an output of its own."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import st_attention as sa

    q, k, v, coord, key_idx, key_mask, tq, tk, tv, _, window, quant, num_bins = args
    B, N, C = q.shape
    key_idx = key_idx.to(torch.int32).contiguous()
    key_mask = key_mask.contiguous()
    out = torch.empty_like(q)

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), coord.data_ptr(),
                 key_idx.data_ptr(), key_mask.data_ptr(),
                 *[None if t is None else t.data_ptr() for t in (tq, tk, tv)],
                 sa.HEAD_DIM ** -0.5, 2 * window, 1e-4, quant, B, N, C,
                 key_idx.shape[-1], num_bins, out.data_ptr(),
                 ctypes.c_void_p(_cuda.stream_of(q)))
        _cuda.check(err, "pcpdf_st_attention")
        return out
    return run


def compare(parent_fn, rng):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import st_attention as sa

    rows, worst = [], 0.0
    dev = torch.device("cuda")
    new_fn = _cuda.library().pcpdf_st_attention
    for case in chip_smoke.ST_CASES:
        C, N, window, quant, K, tables, launches = case
        name, args = chip_smoke.st_attention_case(dev, rng, case)
        with torch.inference_mode():
            old_run, new_run = launcher(parent_fn, args), launcher(new_fn, args)
            old = old_run().clone()
            new = new_run().clone()
            torch.cuda.synchronize()
            err = float((new - old).abs().max()) / max(float(old.abs().max()), 1e-30)
            worst = max(worst, err)
            times = [chip_smoke.graph_ms(f, 10) for f in (old_run, new_run, new_run, old_run)]
            with _cuda.plain_versions():
                plain_ms = chip_smoke.cuda_ms(lambda: sa.st_attention(*args), 3)
        pairs = float(args[5].sum())
        n_bytes, n_flops = chip_smoke.st_attention_bound(2, N, C, K, args[-1], pairs, tables)
        bound_ms, bound_by = chip_smoke.bound(n_bytes, n_flops)
        rows.append({"case": name, "N": N, "C": C, "K": K, "tables": list(tables),
                     "pairs": pairs, "launches_st_forward": launches,
                     "parent_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "rel_err": err})
        speedup = (times[0] + times[3]) / (times[1] + times[2])
        print(f"{name:44s} parent {times[0]:7.4f} / {times[3]:7.4f} ms   new "
              f"{times[1]:7.4f} / {times[2]:7.4f} ms   x{speedup:6.2f}   plain "
              f"{plain_ms:8.3f}   bound {bound_ms:.4f} ({bound_by})   rel err {err:.2e}",
              flush=True)
        del args, old, new
        torch.cuda.empty_cache()
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
    if worst > chip_smoke.TOL_K5:
        raise SystemExit(f"the kernels differ by {worst:.3e} of max |parent|")


if __name__ == "__main__":
    main()
