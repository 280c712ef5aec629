"""K4's backward on one GPU: an earlier tree's kernel beside this tree's, at
the K4 shapes of ``chip_smoke.py`` phase 3 and at the five stage shapes of
the PT-v1 Seg50 train step.

    python3 tools/attn_bwd_compare_torch.py --parent DIR [--out FILE]

``--parent DIR``: a tree holding ``pointcloudpdf_tpu_torch/csrc/`` (the
parent commit unpacked with ``git archive`` into a git-ignored directory,
say).  Its ``vector_attention_bwd.cu`` is built alone with nvcc into
``DIR/_attn_bwd_build/`` and its ``pcpdf_vector_attention_bwd`` is timed
beside this tree's backward (``vector_attention._launch_backward``) on the
same inputs, in turns (parent, this tree, this tree, parent; CUDA events
after a warm-up): the backward alone (the forward saves only its inputs,
so the backward's inputs are those of the forward and the output
gradient), then each backward after the training forward kernel, as a
train step launches them.  The two results are held against each other (d
x and d params, each relative to the parent's max magnitude, on the pairs
off a ReLU kink).  The train-step shapes are B = 16 crops of
58,542-69,770 valid points in the 81,920 bucket (the shipped config's
training batch), every stage a quarter of the one before.  ``bound_ms``
counts the products at the tensor cores' split-TF32 rate
(``chip_smoke.attention_bwd_ops_ms``); ``step`` weighs each width by its
layers in a Seg50 step (2 / 3 / 4 / 6 / 3 at C = 32 / 64 / 128 / 256 /
512).  ``--out`` writes the numbers as JSON.  Needs a CUDA device and nvcc.
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

# attention layers of a Seg50 train step, by width
STEP_LAYERS = {32: 2, 64: 3, 128: 4, 256: 6, 512: 3}
TRAIN_BUCKET = 81920


def cases(rng):
    """(name, B, N, C, K, valid, drop): phase 3's three K4 shapes (B = 2,
    5% of the slots masked), then the train step's five stages."""
    out = [("phase-3 stage-1 C=32 K=8", 2, chip_smoke.N_MAIN, 32, 8, None, 0.05),
           ("phase-3 stage-4 C=256 K=16", 2, chip_smoke.N_MAIN // 64, 256, 16, None, 0.05),
           ("phase-3 stage-5 C=512 K=16", 2, chip_smoke.N_MAIN // 256, 512, 16, None, 0.05)]
    crops = rng.randint(chip_smoke.TRAIN_CROP[0], chip_smoke.TRAIN_CROP[1] + 1, size=16)
    for s, (C, K) in enumerate(((32, 8), (64, 16), (128, 16), (256, 16), (512, 16))):
        n = TRAIN_BUCKET >> (2 * s)
        valid = chip_smoke.train_stage_valid(crops, s)
        out.append((f"train stage-{s + 1} C={C} K={K} N={n}", 16, n, C, K, valid, 0.0))
    return out


def build_parent(tree):
    """nvcc the tree's vector_attention_bwd.cu alone (same flags as the
    port's build)."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    src = os.path.join(tree, "pointcloudpdf_tpu_torch", "csrc", "vector_attention_bwd.cu")
    out_dir = os.path.join(tree, "_attn_bwd_build")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libattn_bwd_parent.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the parent's kernel:\n" + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    fn = lib.pcpdf_vector_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def parent_backward(fn, x_q, x_k, x_v, coord, idx, nmask, params, dout):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda

    B, N, C = x_q.shape
    d_q = torch.empty_like(x_q)
    d_k, d_v, d_p = (torch.zeros_like(x_k), torch.zeros_like(x_v),
                     torch.zeros_like(params))
    err = fn(x_q.data_ptr(), x_k.data_ptr(), x_v.data_ptr(), coord.data_ptr(),
             idx.data_ptr(), nmask.data_ptr(), params.data_ptr(), dout.data_ptr(),
             B, N, C, idx.shape[-1], d_q.data_ptr(), d_k.data_ptr(), d_v.data_ptr(),
             d_p.data_ptr(), ctypes.c_void_p(_cuda.stream_of(x_q)))
    _cuda.check(err, "parent pcpdf_vector_attention_bwd")
    return d_q, d_k, d_v, d_p


def compare(fn, rng):
    import torch

    from pointcloudpdf_tpu_torch.ops import vector_attention as va

    rows = []
    dev = torch.device("cuda")
    for name, B, N, C, K, valid, drop in cases(rng):
        feats, coord, idx, nmask, params = chip_smoke.attention_inputs(
            dev, rng, N, C, K, drop=drop, valid=valid)
        with torch.no_grad():
            cleared = va.mask_off_relu_kinks(*feats, coord, idx, nmask, *params)
            inputs = va._kernel_inputs(*feats, coord, idx, cleared)
            packed = va._pack_params(*params)
            dout = torch.from_numpy(
                rng.standard_normal((len(feats[0]), N, C)).astype(np.float32)).to(dev)
            new = va._launch_backward(*inputs, packed, dout)
            old = parent_backward(fn, *inputs, packed, dout)
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(new, old)]
            iters = 3 if B * N * C * K > 2 ** 28 else 5
            times = [chip_smoke.cuda_ms(lambda: parent_backward(fn, *inputs, packed, dout), iters),
                     chip_smoke.cuda_ms(lambda: va._launch_backward(*inputs, packed, dout), iters),
                     chip_smoke.cuda_ms(lambda: va._launch_backward(*inputs, packed, dout), iters),
                     chip_smoke.cuda_ms(lambda: parent_backward(fn, *inputs, packed, dout), iters)]

            # the training forward kernel (K3's) and a backward
            def step(backward):
                va._launch_forward(*inputs, packed, train=True)
                backward(*inputs, packed, dout)

            parent_step = lambda: step(lambda *a: parent_backward(fn, *a))  # noqa: E731
            new_step = lambda: step(va._launch_backward)  # noqa: E731
            step_ms = [chip_smoke.cuda_ms(f, iters)
                       for f in (parent_step, new_step, new_step, parent_step)]
        pairs = float(cleared.sum())
        n_bytes, n_flops = chip_smoke.attention_bound(B, N, C, K, pairs, True)
        bound_ms, bound_by = chip_smoke.bound(
            n_bytes, n_flops, chip_smoke.attention_bwd_ops_ms(C, pairs))
        rows.append({"case": name, "B": B, "N": N, "C": C, "K": K, "pairs": pairs,
                     "parent_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "forward_backward_parent_ms": [step_ms[0], step_ms[3]],
                     "forward_backward_new_ms": [step_ms[1], step_ms[2]],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "rel_err_dxq_dxk_dxv_dparams": errs})
        speedup = (times[0] + times[3]) / (times[1] + times[2])
        print(f"{name:36s} parent {times[0]:8.3f} / {times[3]:8.3f} ms   new "
              f"{times[1]:8.3f} / {times[2]:8.3f} ms   x{speedup:6.2f}   "
              f"bound {bound_ms:.4f} ({bound_by})   rel err d x "
              f"{max(errs[:3]):.2e}, d params {errs[3]:.2e}; forward + backward: parent "
              f"{step_ms[0]:.3f} / {step_ms[3]:.3f}, new {step_ms[1]:.3f} / {step_ms[2]:.3f} ms",
              flush=True)
        del feats, coord, idx, nmask, params, inputs, packed, dout, new, old, cleared
        torch.cuda.empty_cache()
    train = [r for r in rows if r["case"].startswith("train")]
    steps = {key: sum(STEP_LAYERS[r["C"]] * sum(r[key]) / 2 for r in train)
             for key in ("parent_ms", "new_ms")}
    by_width = {r["C"]: {key: STEP_LAYERS[r["C"]] * sum(r[key]) / 2
                         for key in ("parent_ms", "new_ms")} for r in train}
    print("K4 backward a train step (layers x mean ms), by width: " + "; ".join(
        f"C={c}: parent {v['parent_ms']:.2f}, new {v['new_ms']:.2f}" for c, v in by_width.items())
        + f"; sum: parent {steps['parent_ms']:.2f} ms, new {steps['new_ms']:.2f} ms")
    return rows, {"by_width": by_width, "sum": steps}


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
    from pointcloudpdf_tpu_torch.ops import _cuda

    _cuda.library()
    rows, steps = compare(build_parent(args.parent), np.random.RandomState(chip_smoke.SEED))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows, "step": steps}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
