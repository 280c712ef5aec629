"""K3, the vector attention's forward, on one GPU: an earlier tree's kernel
beside this tree's, at the K3 shapes of ``chip_smoke.py`` phase 3 and at
the five stage shapes of the PT-v1 Seg50 train step.

    python3 tools/attn_fwd_compare_torch.py --parent DIR [--out FILE]

``--parent DIR``: a tree holding ``pointcloudpdf_tpu_torch/csrc/`` (the
parent commit unpacked with ``git archive`` into a git-ignored directory,
say).  Its ``vector_attention.cu`` is built alone with nvcc into
``DIR/_attn_fwd_build/`` and its ``pcpdf_vector_attention`` is timed beside
this tree's (``vector_attention._launch_forward``, W_w1's split pairs made
beforehand) on the same inputs and the same packed parameters, in turns (parent, this tree, this tree,
parent; CUDA events after a warm-up), with ``vector_attention_plain``
beside them.  The two kernels' outputs are held against each other and
against the plain version, each relative to the plain output's max
magnitude, on the pairs off a ReLU kink (``mask_off_relu_kinks``).  The
train-step shapes are B = 16 crops of 58,542-69,770 valid points in the
81,920 bucket (the shipped config's training batch), every stage a quarter
of the one before.  ``bound_ms`` counts the C x G and G x G products at the
tensor cores' split-TF32 rate (``chip_smoke.attention_fwd_ops_ms``);
``step`` weighs each width by its layers in a Seg50 step (2 / 3 / 4 / 6 /
3 at C = 32 / 64 / 128 / 256 / 512).  Last, the packing of an eval layer's
parameters, made anew at every call against the cached packing
(``vector_attention.packed_params``), host clock with the device
synchronised.  ``--out`` writes the numbers as JSON.  Needs a CUDA device
and nvcc.
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
from _profile_torch import card_line  # noqa: E402

# attention layers of a Seg50 train step, by width
STEP_LAYERS = {32: 2, 64: 3, 128: 4, 256: 6, 512: 3}


def cases(rng):
    """(name, N, C, K, valid): phase 3's two serving shapes (B = 2), then
    the train step's five stages (B = 16)."""
    crops = rng.randint(chip_smoke.TRAIN_CROP[0], chip_smoke.TRAIN_CROP[1] + 1, size=16)
    return [("phase-3 stage-1 C=32 K=8", chip_smoke.N_MAIN, 32, 8, None),
            ("phase-3 stage-4 C=256 K=16", chip_smoke.N_MAIN // 64, 256, 16, None),
            *chip_smoke.attention_train_shapes(crops)]


def build_parent(tree):
    """nvcc the tree's vector_attention.cu alone (same flags as the port's
    build)."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    src = os.path.join(tree, "pointcloudpdf_tpu_torch", "csrc", "vector_attention.cu")
    out_dir = os.path.join(tree, "_attn_fwd_build")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libattn_fwd_parent.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the parent's kernel:\n" + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    fn = lib.pcpdf_vector_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def parent_forward(fn, x_q, x_k, x_v, coord, idx, nmask, params):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda

    B, N, C = x_q.shape
    out = torch.empty_like(x_q)
    err = fn(x_q.data_ptr(), x_k.data_ptr(), x_v.data_ptr(), coord.data_ptr(),
             idx.data_ptr(), nmask.data_ptr(), params.data_ptr(), B, N, C,
             idx.shape[-1], out.data_ptr(), ctypes.c_void_p(_cuda.stream_of(x_q)))
    _cuda.check(err, "parent pcpdf_vector_attention")
    return out


def compare(fn, rng):
    import torch

    from pointcloudpdf_tpu_torch.ops import vector_attention as va

    rows = []
    dev = torch.device("cuda")
    for name, N, C, K, valid in cases(rng):
        feats, coord, idx, nmask, params = chip_smoke.attention_inputs(
            dev, rng, N, C, K, valid=valid)
        B = len(feats[0])
        with torch.no_grad():
            cleared = va.mask_off_relu_kinks(*feats, coord, idx, nmask, *params)
            inputs = va._kernel_inputs(*feats, coord, idx, cleared)
            packed = va._pack_params(*params)
            w1s = va._split_w1(packed, C)
            new = va._launch_forward(*inputs, packed, w1s=w1s)
            old = parent_forward(fn, *inputs, packed)
            plain = va.vector_attention_plain(*feats, coord, idx, cleared, *params)
            torch.cuda.synchronize()
            scale = float(plain.abs().max())
            errs = {"new_vs_parent": float((new - old).abs().max()) / scale,
                    "new_vs_plain": float((new - plain).abs().max()) / scale,
                    "parent_vs_plain": float((old - plain).abs().max()) / scale}
            del new, old, plain
            iters = 5 if B * N * C > 2 ** 26 else 10
            times = [chip_smoke.cuda_ms(lambda: parent_forward(fn, *inputs, packed), iters),
                     chip_smoke.cuda_ms(lambda: va._launch_forward(*inputs, packed, w1s=w1s), iters),
                     chip_smoke.cuda_ms(lambda: va._launch_forward(*inputs, packed, w1s=w1s), iters),
                     chip_smoke.cuda_ms(lambda: parent_forward(fn, *inputs, packed), iters)]
            plain_ms = chip_smoke.cuda_ms(
                lambda: va.vector_attention_plain(*feats, coord, idx, cleared, *params), 2)
        pairs = float(cleared.sum())
        n_bytes, n_flops = chip_smoke.attention_bound(B, N, C, K, pairs, False)
        bound_ms, bound_by = chip_smoke.bound(
            n_bytes, n_flops, chip_smoke.attention_fwd_ops_ms(C, pairs))
        rows.append({"case": name, "B": B, "N": N, "C": C, "K": K, "pairs": pairs,
                     "parent_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "rel_err": errs})
        speedup = (times[0] + times[3]) / (times[1] + times[2])
        print(f"{name:32s} parent {times[0]:8.3f} / {times[3]:8.3f} ms   new "
              f"{times[1]:8.3f} / {times[2]:8.3f} ms   x{speedup:6.2f}   plain "
              f"{plain_ms:8.3f} ms   bound {bound_ms:.4f} ({bound_by})   rel err new-parent "
              f"{errs['new_vs_parent']:.2e}, new-plain {errs['new_vs_plain']:.2e}, "
              f"parent-plain {errs['parent_vs_plain']:.2e}", flush=True)
        del feats, coord, idx, nmask, params, inputs, packed, w1s, cleared
        torch.cuda.empty_cache()
    train = [r for r in rows if r["case"].startswith("train")]
    by_width = {r["C"]: {key: STEP_LAYERS[r["C"]] * sum(r[key]) / 2
                         for key in ("parent_ms", "new_ms")} for r in train}
    steps = {key: sum(v[key] for v in by_width.values()) for key in ("parent_ms", "new_ms")}
    steps["bound_ms"] = sum(STEP_LAYERS[r["C"]] * r["bound_ms"] for r in train)
    print("K3 a train step (layers x mean ms), by width: " + "; ".join(
        f"C={c}: parent {v['parent_ms']:.2f}, new {v['new_ms']:.2f}" for c, v in by_width.items())
        + f"; sum: parent {steps['parent_ms']:.2f} ms, new {steps['new_ms']:.2f} ms, "
        f"bound {steps['bound_ms']:.2f} ms")
    return rows, {"by_width": by_width, "sum": steps}


def packing_ms(dev, C=256, calls=50):
    """Host ms a call of an eval layer's packing: made anew, and cached."""
    import torch

    from pointcloudpdf_tpu_torch.models.point_transformer import PointTransformerLayer
    from pointcloudpdf_tpu_torch.ops import vector_attention as va

    layer = PointTransformerLayer(C, C).to(dev).eval()
    mlps = (layer.linear_p, layer.linear_w)

    def anew():
        params = va._pack_params(*va.eval_params(*mlps))
        return params, va._split_w1(params, C)

    out = {}
    with torch.no_grad():
        for key, pack in (("anew", anew), ("cached", lambda: va.packed_params(*mlps))):
            pack()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                pack()
            torch.cuda.synchronize()
            out[key] = (time.perf_counter() - t0) * 1e3 / calls
    print(f"eval packing at C={C}, host ms a call: anew {out['anew']:.4f}, "
          f"cached {out['cached']:.4f}")
    return out


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True, help="tree of the earlier kernel")
    parser.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    from pointcloudpdf_tpu_torch.ops import _cuda

    _cuda.library()
    rows, steps = compare(build_parent(args.parent), np.random.RandomState(chip_smoke.SEED))
    packing = packing_ms(torch.device("cuda"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows, "step": steps, "packing_ms": packing},
                      f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
