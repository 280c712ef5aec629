"""K7 on one GPU: an earlier tree's kernel beside this tree's, at the K7
shapes of ``chip_smoke.py`` phase 3.

    python3 tools/gva_compare_torch.py --parent DIR [--out FILE]

``--parent DIR``: a tree holding ``pointcloudpdf_tpu_torch/csrc/`` (the
parent commit unpacked with ``git archive`` into a git-ignored directory,
say).  Its ``gva.cu`` is built alone with nvcc into ``DIR/_gva_build/`` and
its ``pcpdf_gva`` is timed beside this tree's on the same packed inputs, in
turns (parent, this tree, this tree, parent; CUDA events after a warm-up):
the kernels alone, then this tree's wrapper (``grouped_vector_attention``:
the cached parameter packing and the kernel) beside them, and the packing
alone on the host clock, made anew and cached.  The two outputs are
held against each other, relative to the parent's max magnitude.
``bound_ms`` counts the products at the tensor cores' split-TF32 rate
(``chip_smoke.gva_ops_ms``).  ``--out`` writes the numbers as JSON, with
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
    """nvcc the tree's gva.cu alone (same flags as the port's build)."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    src = os.path.join(tree, "pointcloudpdf_tpu_torch", "csrc", "gva.cu")
    out_dir = os.path.join(tree, "_gva_build")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libgva_parent.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the parent's kernel:\n" + proc.stdout + proc.stderr)
    fn = ctypes.CDLL(so).pcpdf_gva
    fn.argtypes = _cuda._SIGNATURES["pcpdf_gva"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, args, split):
    """A call of ``fn`` (a ``pcpdf_gva``) on the wrapper's arguments, its
    parameters packed once: the C x C matrices as split-TF32 pairs
    (``split``, this tree) or as f32 (C, C) (the earlier one-warp-a-query
    kernel)."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda, gva

    q, k, v, coord, idx, nmask, pem, peb, we, groups = args
    B, N, C = q.shape
    small, m2w, b2w = gva.pack_params(pem, peb, we, C, groups)
    if not split:
        m2w, b2w = (gva._folded(seq, (3, C), q.device)[4].float().contiguous()
                    for seq in (pem, peb))
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty_like(q)

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), coord.data_ptr(),
                 idx.data_ptr(), nmask.data_ptr(), small.data_ptr(), m2w.data_ptr(),
                 b2w.data_ptr(), int(pem is not None), int(peb is not None), B, N, C,
                 idx.shape[-1], out.data_ptr(), ctypes.c_void_p(_cuda.stream_of(q)))
        _cuda.check(err, "pcpdf_gva")
        return out
    return run


def host_ms(fn, iters):
    """Milliseconds a call on the host clock, the device synchronised at
    both ends (the packing's host time, its small kernels included)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def compare(parent_fn, rng):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda, gva

    rows = []
    dev = torch.device("cuda")
    new_fn = _cuda.library().pcpdf_gva
    for N, C, pe in chip_smoke.GVA_CASES:
        args, _ = chip_smoke.gva_inputs(dev, rng, N, C, pe)
        name = chip_smoke.gva_case_name(N, C, pe, args[4].shape[-1])
        with torch.inference_mode():
            old_run, new_run = launcher(parent_fn, args, False), launcher(new_fn, args, True)
            old = old_run().clone()
            new = new_run().clone()
            torch.cuda.synchronize()
            err = float((new - old).abs().max()) / max(float(old.abs().max()), 1e-30)
            times = [chip_smoke.cuda_ms(f, 5) for f in (old_run, new_run, new_run, old_run)]
            wrapper = chip_smoke.cuda_ms(lambda: gva.grouped_vector_attention(*args), 5)
            pack_ms = host_ms(lambda: gva.pack_params(*args[6:9], C, C // 8), 20)
            cached_ms = host_ms(lambda: gva.packed_params(*args[6:9], C, C // 8), 20)
        pairs = float(args[5].sum())
        n_bytes, n_flops = chip_smoke.gva_bound(2, N, C, C // 8, args[4].shape[-1], pairs,
                                                pe[0] + pe[1])
        bound_ms, bound_by = chip_smoke.bound(
            n_bytes, n_flops, chip_smoke.gva_ops_ms(C, pairs, pe[0] + pe[1]))
        rows.append({"case": name, "N": N, "C": C, "pe_multiplier": pe[0],
                     "pe_bias": pe[1], "pairs": pairs,
                     "parent_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "new_wrapper_ms": wrapper, "pack_host_ms": pack_ms,
                     "cached_pack_host_ms": cached_ms,
                     "bound_ms": bound_ms,
                     "bound_by": bound_by, "rel_err": err})
        speedup = (times[0] + times[3]) / (times[1] + times[2])
        print(f"{name:40s} parent {times[0]:8.3f} / {times[3]:8.3f} ms   new "
              f"{times[1]:8.3f} / {times[2]:8.3f} ms   x{speedup:6.2f}   wrapper "
              f"{wrapper:.3f} ms (packing {pack_ms:.3f}, cached {cached_ms:.3f})   bound {bound_ms:.4f} ({bound_by})   rel err {err:.2e}",
              flush=True)
        del args, old, new
        torch.cuda.empty_cache()
    return rows


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True, help="tree of the earlier kernel")
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    rows = compare(build_parent(args.parent), np.random.RandomState(chip_smoke.SEED))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
