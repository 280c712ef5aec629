"""PT-v3's RPE lookup, forward and backward, by several plain-PyTorch
formulations, on one GPU.

    python3 tools/ptv3_rpe_compare_torch.py [--out FILE]

At the shapes of ``chip_smoke.py`` phase 14's training step (the S3DIS
``-rpe`` config, patches of 128): level 0 (B = 2, a bucket of 327,680 rows,
H = 2) and level 3 (40,960 rows, H = 16), the rows a room of phase 14
(``chip_smoke.PTV3_ROOM``) voxelised at 2 cm (level 3: at 16 cm) in
Hilbert order in the first sample, the second empty (a Mix3D pair's
empty slot).  Each variant computes the (B, P, K, K, H) bias from the
(3 rpe_num, H) table and, from a fixed output gradient (0 at the pairs
with a padded query or key, as in the model), the table's gradient:

- ``embedding``: ``F.embedding`` into the table of every offset triple
  (``rpe_num^3`` rows); its backward sorts the indices and sums each row's
  slots in parallel pieces, then the pieces of a row one after another;
- ``embedding_unspread``: the same with the padded pairs at the zero
  offset, as ``ptv3.rpe_index`` left them before it spread them;
- ``index_select``: the same lookup by ``index_select``, whose backward is
  ``index_add_`` (atomic adds);
- ``bincount``: the forward as ``embedding``, the backward one
  ``torch.bincount`` (a histogram weighted by the gradient) an axis and a
  head, over each axis's offset;
- ``scatter_rows``: the forward as ``embedding``, the backward a
  ``scatter_add_`` of each query row's K keys into its axis's ``rpe_num``
  bins, then a sum over the rows.

Prints each variant's forward and forward + backward ms by CUDA events (in
turns, after a warm-up), and fails unless every gradient is within 1e-4 of
max |grad| of ``embedding``'s and every bias equal.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def level_rows(stride, n_pad):
    """(B = 2, n_pad, 3) grid and mask: phase 14's room at 2 cm x stride in
    the first sample, the second empty (a Mix3D pair's empty slot, as in
    phase 14's step)."""
    import chip_smoke

    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "room.npz")
        chip_smoke.synthetic_room(np.random.RandomState(chip_smoke.SEED), path,
                                  **chip_smoke.PTV3_ROOM)
        coord = np.load(path)["coord"]
    grid = np.unique(np.floor((coord - coord.min(0)) / (0.02 * stride)).astype(np.int64),
                     axis=0)
    n = min(len(grid), n_pad)
    out = np.zeros((2, n_pad, 3), np.int64)
    out[0, :n] = grid[np.random.RandomState(1).permutation(len(grid))[:n]]
    mask = np.zeros((2, n_pad), bool)
    mask[0, :n] = True
    return out, mask, n


def main():
    import torch
    from torch.nn import functional as F

    from pointcloudpdf_tpu_torch.models.point_transformer_v3 import ptv3

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _profile_torch import card_line

    card = card_line()
    print(card)
    dev = torch.device("cuda")

    def split_rows(table, r):
        tx, ty, tz = table.split(r)
        return ((tx[:, None, None] + ty[None, :, None]) + tz[None, None, :]).reshape(r ** 3, -1)

    class HistogramRPE(torch.autograd.Function):
        """Forward by the triple table; backward by ``backward_fn``."""

        @staticmethod
        def forward(ctx, table, index, r, backward_fn):
            ctx.save_for_backward(index)
            ctx.r, ctx.backward_fn = r, backward_fn
            return F.embedding(index, split_rows(table, r))

        @staticmethod
        def backward(ctx, grad):
            (index,) = ctx.saved_tensors
            return ctx.backward_fn(index, grad, ctx.r), None, None, None

    def axis_index(index, r, axis):
        return (index // r ** (2 - axis)) % r

    def bincount_grad(index, grad, r):
        h = grad.shape[-1]
        out = grad.new_zeros((3 * r, h))
        for axis in range(3):
            flat = axis_index(index, r, axis).reshape(-1)
            for j in range(h):
                out[axis * r:(axis + 1) * r, j] = torch.bincount(
                    flat, weights=grad[..., j].reshape(-1), minlength=r)
        return out

    def scatter_rows_grad(index, grad, r):
        b, p, k, _, h = grad.shape
        out = grad.new_zeros((3 * r, h))
        g = grad.permute(0, 1, 2, 4, 3)                       # (B, P, K, H, K)
        for axis in range(3):
            idx = axis_index(index, r, axis).long()[:, :, :, None, :].expand(-1, -1, -1, h, -1)
            bins = grad.new_zeros((b, p, k, h, r)).scatter_add_(-1, idx, g)
            out[axis * r:(axis + 1) * r] = bins.sum((0, 1, 2)).t()
        return out

    variants = {
        "embedding_unspread": lambda t, i, r: F.embedding(i, split_rows(t, r)),
        "embedding": lambda t, i, r: F.embedding(i, split_rows(t, r)),
        "index_select": lambda t, i, r: split_rows(t, r).index_select(
            0, i.reshape(-1)).reshape(*i.shape, -1),
        "bincount": lambda t, i, r: HistogramRPE.apply(t, i, r, bincount_grad),
        "scatter_rows": lambda t, i, r: HistogramRPE.apply(t, i, r, scatter_rows_grad),
    }
    result = {"card": card, "levels": []}
    for name, stride, n_pad, heads in (("level 0", 1, 327680, 2), ("level 3", 8, 40960, 16)):
        grid, mask, n = level_rows(stride, n_pad)
        grid, mask = torch.from_numpy(grid).to(dev), torch.from_numpy(mask).to(dev)
        perm, _ = ptv3._sort_orders(grid, mask, ("hilbert",))
        index = ptv3.rpe_index(grid, mask, perm[0], 128)
        # the padded pairs at the zero offset, as before their rows were spread
        unspread = ptv3.rpe_index(grid, torch.ones_like(mask), perm[0], 128)
        r = 2 * ptv3.rpe_bound(128) + 1
        gen = torch.Generator(device=dev).manual_seed(0)
        table0 = torch.randn((3 * r, heads), device=dev, generator=gen)
        valid = F.pad(mask.gather(1, perm[0]), (0, index.shape[1] * 128 - n_pad))
        valid = valid.reshape(index.shape[:3])
        # the model's gradient is 0 at a pair with a padded query or key
        dout = torch.randn(index.shape + (heads,), device=dev, generator=gen) * (
            valid[..., :, None] & valid[..., None, :])[..., None]
        used = torch.bincount(index.reshape(-1).long(), minlength=r ** 3)
        row = dict(level=name, rows=n, bucket=n_pad, heads=heads, pairs=index.numel(),
                   table_rows_used=int((used > 0).sum()),
                   hottest_row_share=float(used.max()) / index.numel())
        print(f"{name}: {n} rows of {n_pad}, H = {heads}, {index.numel()} pairs, "
              f"{row['table_rows_used']} of {r ** 3} triple rows used, the hottest "
              f"{row['hottest_row_share']:.4f} of the pairs")
        ref = {}
        for key, fn in variants.items():
            table = table0.clone().requires_grad_(True)
            bias = fn(table, unspread if key == "embedding_unspread" else index, r)
            bias.backward(dout)
            ref[key] = (bias.detach(), table.grad.clone())
        base_bias, base_grad = ref["embedding"]
        scale = float(base_grad.abs().max())
        for key, (bias, grad) in ref.items():
            err = float((grad - base_grad).abs().max()) / scale
            row[f"{key}_grad_err"] = err
            # the padded pairs' bias differs (it is masked in the model)
            same = torch.equal(torch.where((valid[..., :, None] & valid[..., None, :])[..., None],
                                           bias - base_bias, 0 * bias), 0 * bias)
            if not same or err > 1e-4:
                raise SystemExit(f"{name} {key}: bias equal {same}, "
                                 f"grad err {err:.3e} of max |grad|")
        times = {key: [] for key in variants}
        fwd = {key: [] for key in variants}
        for key in [*variants, *reversed(list(variants))]:   # in turns
            table = table0.clone().requires_grad_(True)
            start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            torch.cuda.synchronize()
            start.record()
            bias = variants[key](table, unspread if key == "embedding_unspread" else index, r)
            mid.record()
            bias.backward(dout)
            end.record()
            torch.cuda.synchronize()
            fwd[key].append(start.elapsed_time(mid))
            times[key].append(start.elapsed_time(end))
        for key in variants:
            row[f"{key}_fwd_ms"] = fwd[key]
            row[f"{key}_fwd_bwd_ms"] = times[key]
            print(f"  {key:13s} forward {fwd[key]} ms, forward + backward {times[key]} ms, "
                  f"grad err {row[f'{key}_grad_err']:.2e}")
        result["levels"].append(row)
        del index, dout, ref
        torch.cuda.empty_cache()
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
