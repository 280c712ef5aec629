#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the CUDA kernels from ``pointcloudpdf_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on CUDA tensors at the
   main path's shapes, with both times (CUDA events; K1, K2, K5 and K6
   from a CUDA graph of calls) and the least time the card could take for
   the same work (its bound); K1 at nineteen shapes: eight for the bound-pruned
   kernel's range and the ST sparse keys, one of them a val-pass-sized set
   of 262,144 points, each with the share of the brute-force work that the
   bound-pruned kernel visited and, where it runs, its plan (prep kernels)
   against the plain plan, and eleven of the brute-force kernel at the
   PT-v1 serving forward's and the train step's shapes and at its edges;
   K2 exact and on the windows of the blocked call at the paths' three
   window shapes, the windows kernel alone beside the whole call, neither
   K2 kernel spilling registers; K3 at seven,
   two serving stages at B = 2 and the train step's five stages at B = 16;
   K4 at five, three stages at B = 2 and the train step's stages 4 and 5
   at B = 16; neither vector-attention kernel spilling registers; K5 at
   five, the ST config's three layer shapes, the module's defaults (no key
   or value table) and K = 64, each with its bins read back through the
   kernel, its time from a CUDA graph and no spill; K6 at the ST stem's
   two shapes, padded rows 0, neither instantiation spilling registers;
   K7 at seven, every width the shipped PT-v2m2 configs launch and two
   probes of the other branch combinations, none of its instantiations
   spilling registers;
4. the serving slice end to end: a seeded synthetic room in the S3DIS
   layout, seeded random Seg50 + PDF-recognizer weights written through
   the bridge as a JAX-layout checkpoint, ``tools/test_torch.py`` on the
   shipped open-set config on the card with every kernel's launch count
   checked, then one fragment re-run on the plain versions and compared;
5. the training slice end to end: synthetic rooms split into train areas
   and a val area, ``tools/train_torch.py`` on the shipped config at full
   width (a handful of steps, the last epoch past
   ``recognizer.start_epoch``), the launch counts of every kernel, then
   ``tools/test_torch.py`` on the checkpoint the trainer saved;
6. three train steps from one seeded state on one fixed batch, on the
   kernels and on the plain versions: the losses and the first step's
   whole-network gradient compared, and every attention layer of that step
   again on the inputs and the output gradient it had there, kernel
   against plain version; one more step under bfloat16 autocast;
7. the Stratified Transformer serving slice end to end: seeded random
   ST-v1m1 + ST-recognizer weights through the bridge,
   ``tools/test_torch.py`` on the shipped S3DIS ST config over the
   synthetic room, the launch counts of a forward (K5 ten times, K6 twice,
   K1 and K2 as the modules imply), then one fragment on the plain versions;
8. the Point Transformer V2 serving slice end to end: seeded random PT-v2m2
   weights through the bridge as a closed-set checkpoint,
   ``tools/test_torch.py`` on the shipped S3DIS PT-v2m2 config
   (``SemSegTester``) over the synthetic room, the launches of a forward
   (K7 fifteen times, K1 four times, no other kernel), no point dropped by
   the pooling capacity, then one fragment on the plain versions;
9. the Stratified Transformer open-set training slice end to end:
   ``tools/train_torch.py`` on the shipped S3DIS ST config at full width
   over phase 5's rooms (batch 4, else 2: the shipped 16 and 8 do not fit;
   two epochs of one step), the last epoch past ``recognizer.start_epoch``;
   K5 and K6 launched in the
   score passes and evaluator forwards alone (the training forwards take
   their plain versions), then ``tools/test_torch.py`` on its checkpoint;
10. the incremental slice end to end: ``tools/train_torch.py`` on the
   shipped incremental config from phase 5's checkpoint (frozen Seg50
   teacher on K3, Seg50 student with two more classes on K4), then
   ``tools/test_torch.py`` (``IncrSegTester``) on the student; one
   incremental step on the kernels and on the plain versions, and the
   teacher's logits under bfloat16 autocast against its f32 plain version;
11. the PT-v2 training slice end to end: ``tools/train_torch.py`` on the
   shipped S3DIS PT-v2m2 config at full width over phase 5's rooms (the
   largest batch of 12, 6, 3, 2, 1 that fits; autocast, Mix3D, drop path as
   shipped), one epoch of two steps, the evaluator, and ``PreciseEvaluator``
   appended to the hooks (``SemSegTester`` on ``model_best.pth``); K7
   fifteen times (3 / 3 / 7 / 2 by width) in each evaluator and tester
   forward and never in a training forward, K1 four times in every forward,
   no point dropped by the pooling capacity; one val batch on the kernels
   and on the plain versions; one step's loss under autocast against f32;
   one ``DefaultTrainer`` step and one eval forward of CAC-v1m1 over the
   ScanNet PT-v2m2 at full width (its own loss and four parts; K7 in the
   eval forward alone);
12. the data-parallel engine: (a) ``launch`` with two gloo ranks sharing
   the card, the shipped open-set config at full width, global batch 16 =
   2 x 8 (or the largest of 8, 4 that fits), three steps from one seeded
   state (Mix3D off, the last two past ``start_epoch``) against one
   process on the same global batches and kernels: the losses, the first
   step's gradient (both f32 gradients held against one process's float64
   gradient on the plain versions, ``check_first_gradient``, and the
   float64 gradient of two ranks against one process's), the running
   statistics (equal on both ranks, within
   ``TOL_DDP_STATS`` of one process's after the first step), the
   parameters equal on both ranks after every step, K1-K4's launches in
   each rank equal to one process's, each batch's score sheets from the
   start's weights within ``TOL_DDP_SHEETS`` and the host graph stage on
   one process's sheets with the ranks' seeds bit-equal to its
   pseudo-labels (those on a rank's own sheets, and those of the steps
   after an update, printed as an IoU), and one process run twice on the
   same batches;
   (b) one step past ``start_epoch`` through ``launch(backend="nccl")`` at
   world 1 (every collective of the path issued), its outputs bit-equal to
   the step without ``launch``; (c) ``tools/test_torch.py``'s path on two
   gloo ranks over phase 4's room and a second one, pred and score files
   bit-equal to one process's (phase 4's room's to phase 4's too) and the
   same metrics.  It prints the step's ms at world 1 and 2, the gradient
   all-reduce's ms and the peak memory of a rank;
13. the SpUNet family (no kernel of its own, so no K1-K7 launch anywhere
   in it, asserted): (a) seeded random SpUNet-v1m1 weights through the
   bridge, ``tools/test_torch.py`` on the shipped S3DIS SpUNet config over
   phase 4's room, the largest fragment's voxel maps (neighbour tables,
   parent maps) built on the card equal to the CPU's bit for bit, its
   logits within ``TOL_SPUNET_LOGITS`` of the port's CPU forward, no point
   dropped by the level capacities; (b) ``tools/train_torch.py`` on that
   config at full width over phase 5's rooms (the largest batch of 12, 6,
   3, 2, 1 that fits; autocast and Mix3D as shipped), one epoch of two
   steps and the evaluator, ``tools/test_torch.py`` on the checkpoint, then
   one batch's train step timed, its peak memory and its share in
   PyTorch's ``indexing_backward_kernel`` (at most
   ``MAX_INDEXING_BACKWARD_SHARE``); (c) one ``DefaultTrainer`` step and
   one eval forward each of MinkUNet34C and of CAC-v1m1 over SpUNet (2 x
   8,000 points, ScanNet's grid), and an eval forward of SpUNet-v1m3 under
   each of its three conditions;
14. PT-v3m1 (no kernel of its own, so no K1-K7 launch anywhere in it,
   asserted): (a) seeded random PT-v3m1 weights through the bridge,
   ``tools/test_torch.py`` on the shipped S3DIS ``-rpe`` config over phase
   4's room at four times its density with normals (``PTV3_ROOM``: the
   config's half capacities assume a scanned surface at 2 cm), the largest
   fragment's voxel maps and the four curve sorts of every level built on
   the card equal to the CPU's bit for bit, its logits on a crop of it
   (``CPU_CROP``) within ``TOL_PTV3_LOGITS`` of the port's CPU forward, no
   point dropped by the
   level capacities, one forward profiled; (b) ``tools/train_torch.py`` on
   that config at full width over phase 5's rooms as ``PTV3_ROOM`` makes
   them (batch 2, else 1: the shipped 12, 6 and 3 do not fit; AdamW, OneCycleLR,
   ``param_dicts``, autocast, Mix3D and drop path as shipped), one epoch of
   two steps and the evaluator (its batches on the ``origin_coord`` /
   ``origin_segment`` path), ``tools/test_torch.py`` on the checkpoint, one
   batch's train step timed with its peak memory and its share in
   ``indexing_backward_kernel`` (at most ``MAX_INDEXING_BACKWARD_SHARE``),
   one step's loss under autocast against f32; (c) one ``DefaultTrainer``
   step and one eval forward of the shipped ScanNet PT-v3m1 config
   (patches of 1,024, no RPE) on 2 x 8,000 points at ScanNet's grid, with
   its peak memory;
15. Point Prompt Training (no kernel of its own, so no K1-K7 launch
   anywhere in it, asserted): (a) seeded synthetic scenes in the
   Structured3D, ScanNet and S3DIS layouts (phase 14's rooms, each labelled
   in its dataset's class space: 25 / 20 / 13), ``tools/train_torch.py`` on
   the shipped S3DIS PPT config (PPT-v1m1 over SpUNet-v1m3) at full width
   (batch 2, else 1: the shipped 12, 6 and 3 do not fit; SGD, OneCycleLR,
   autocast and Mix3D as shipped), one epoch of four steps at the
   datasets' ratios 2 : 1 : 1, each step's condition its batch's dataset's,
   the evaluator on the S3DIS val area under ``S3DIS``;
   ``tools/test_torch.py`` on the checkpoint through a config that adds a
   ``data.test`` under ``S3DIS``; the largest fragment's voxel maps on the
   card equal to the CPU's, its logits under ``S3DIS`` on a crop of it
   within ``TOL_SPUNET_LOGITS`` of the port's CPU forward and each condition's
   head on the card, its forward timed; one batch's train step timed with its peak memory, its
   ``indexing_backward_kernel`` share and its loss under autocast against
   f32; (b) one ``MultiDatasetTrainer`` step and one eval forward of the
   shipped S3DIS PT-v3 PPT-extreme config (PD BatchNorm and LayerNorm
   banks, patches of 1,024) at batch 1 (the shipped 24, 12, 6 and 2 do
   not fit), with its peak memory; (c) one step and one eval forward of the
   SemanticKITTI PPT-v1m2 model dict (over SpUNet-v1m3) on 2 x 8,000
   indoor points, its idle heads moved by AdamW's decay alone;
16. Swin3D and OctFormer (K1 in Swin3D's kNN pooling and interpolation,
   no other kernel): (a) ``tools/test_torch.py`` on the shipped S3DIS
   Swin3D-small config over phase 14's room, K1 eight times a forward, the
   largest fragment on the kernels against the plain versions
   (``TOL_LOGITS``) and a crop of it (``CPU_CROP``) against the port's CPU
   forward (``TOL_WINDOW_LOGITS``), its levels' valid and held rows, one
   forward timed and profiled; (b) ``tools/train_torch.py`` on it at full
   width over phase 14's rooms (the largest of 3, 2, 1 that fits: the
   shipped 12 and 6 do not; OctFormer's of 6, 3, 2, 1; AdamW with the
   ``blocks`` group, autocast, Mix3D and drop path as
   shipped), one epoch of two steps and the evaluator, K1 launched, then
   one batch's step timed with its peak, idle share, levels and
   ``indexing_backward_kernel`` share; (c) and (d) the same for the shipped
   ScanNet OctFormer config over those rooms relabelled into ScanNet's
   layout, its displacement projected on the normal (``octformer_config``),
   no kernel of K1-K7 launched;
17. instance segmentation and OA-CNNs (no kernel of their own, so no K1-K7
   launch anywhere in it, asserted), over phase 14's rooms, each plane and
   box an instance: (a) ``tools/train_torch.py`` on the shipped S3DIS
   PointGroup config at full width (the largest batch of 12, 6, 3, 2, 1
   that fits; SGD with Nesterov, PolyLR and autocast as shipped), one epoch
   of two steps and ``InsSegEvaluator`` (mAP, AP50, AP25); the shipped hook
   again on the checkpoint, its AP table against the host functions
   recomputed on the card's outputs bit for bit, the largest val scene's
   ``seg_logits`` and ``bias_pred`` within ``TOL_SPUNET_LOGITS`` of the
   port's CPU forward, the proposals and the host clustering's ms a scene;
   one batch's step timed with its peak, idle share and
   ``indexing_backward_kernel`` share; (b) one ``DefaultTrainer`` step, an
   eval forward and ``propose`` of the ScanNet, ScanNet200 and S3DIS PPT
   fine-tune (under ``S3DIS``) PointGroup configs on 2 x 8,000 points at
   their grids, each with its peak; (c) ``tools/test_torch.py`` on the
   shipped ScanNet OA-CNNs config over phase 16's ScanNet layout, the
   largest fragment's voxel and cluster maps on the card equal to the CPU's
   bit for bit, its logits on a crop within 1e-4 x max |logit| of the CPU
   forward, its levels, one forward timed; (d) ``tools/train_torch.py`` on
   it at full width (the largest of 12, 6, 3, 2, 1; AdamW, OneCycleLR, CE +
   Lovasz, autocast and Mix3D as shipped), the evaluator,
   ``tools/test_torch.py`` on the checkpoint, one step timed;
18. outdoor LiDAR, over seeded synthetic scans written in each dataset's
   layout (``lidar_scan``: a spinning LiDAR's rings cast against a ground
   plane, boxes, poles and a square of walls; SemanticKITTI 64 beams,
   120,000 points to 34 m; nuScenes 32 beams, 35,008 points to 60 m; Waymo
   64 beams, 169,984 points to 74 m, 2,960 cells at 5 cm): (a)
   ``tools/test_torch.py`` on the shipped SemanticKITTI PT-v2m2 config (K7
   seventeen times a forward by width, K1 five, both K1 kernels, nothing
   dropped), the largest fragment again on the plain versions and, on a
   crop, on the CPU, its forward timed and profiled with K7's shapes; (b)
   ``tools/train_torch.py`` on the SemanticKITTI SpUNet config at full
   width (the largest of 12, 6, 3, 2, 1; SGD with Nesterov, OneCycleLR,
   autocast and Mix3D as shipped), the evaluator, ``tools/test_torch.py``
   on the checkpoint, one step timed; (c) the Waymo SpUNet config's tester
   on a scan past 2,048 cells in x and y: the largest fragment's voxel maps
   on the card bit-equal to the CPU's, its logits on a band along x within
   1e-4 x max |logit| of the CPU's; (d) a step each of MinkUNet34C, the
   SemanticKITTI PT-v3m1 config (its tied curve cells counted) and the
   nuScenes SpUNet config, and three ``MultiDatasetTrainer`` steps of the
   SemanticKITTI PPT-v1m1 config, one a dataset; (e) the SemanticKITTI
   benchmark-submit tester on a test scan without labels, its
   ``submit/.../*.label`` one raw id a point.  Runs alone from a script
   that builds the kernels and calls ``run_outdoor_slice(work)``.

Each phase prints its wall time.  The next-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import itertools
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "s3dis",
                      "openseg-pt-v1-0-pointpdf-v1m1-base.py")
ST_CONFIG = os.path.join(ROOT, "configs", "s3dis",
                         "openseg-st-v1m1-0-origin-pointpdf-v1m1-base.py")
PTV2_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-pt-v2m2-0-base.py")
INCR_CONFIG = os.path.join(ROOT, "configs", "s3dis",
                           "incrseg-pt-v1-0-pointpdf-v1m1-base.py")
SEED = 0
DEVICE = "cuda"
N_MAIN = 65536      # the bucket of a full-size S3DIS fragment
N_EXACT = 32768     # exact FPS: N points, N/4 picks
N_VAL = 262144      # a val-pass-sized kNN set, B = 1
# K2's blocked calls at the paths' window shapes, B = 2: (name, N, m,
# max_group_steps); PT-v1's TransitionDown (windows of 256 x 64), the ST
# downsampling (512 x 128) and the ST key sets (1,024 x 128)
FPS_WINDOW_CASES = (("PT-v1 TransitionDown", N_MAIN, N_MAIN // 4, 64),
                    ("ST downsampling", N_MAIN, N_MAIN // 4, 128),
                    ("ST key sets", N_MAIN, N_MAIN // 8, 128))
ROOM = (5.0, 4.0, 3.0)  # metres: an S3DIS office
MIN_FRAGMENT = 32768
TOL_K3 = 1e-4       # relative to max |plain|: f32 sums in another order
TOL_K5 = 1e-4       # relative to max |plain|: f32 sums in another order, split-TF32 products
TOL_K6 = 1e-4       # relative to max |plain|: f32 sums in another order
TOL_K7 = 1e-4       # relative to max |plain|: f32 sums in another order, online softmax
TOL_K4_X = 1e-4     # K4 forward and d x_q/x_k/x_v, relative to max |plain|
TOL_K4_PARAM = 1e-3  # K4 parameter/affine gradients: sums over up to 1M rows
TOL_STEPS = 1e-3    # losses of three train steps, kernels against plain versions
STEPS_LR = 0.005    # the learning rate of those three steps
TOL_GRAD = 0.25     # a whole-network gradient tensor, of its max |grad| (f32 noise)
TOL_GRAD_WHOLE = 0.05  # the whole-network gradient, in L2
TRAIN_ROOMS = 32    # synthetic rooms over the five train areas
TRAIN_AREAS = ("Area_1", "Area_2", "Area_3", "Area_4", "Area_6")
# published peaks of one H100 SXM (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_SPLIT_FLOPS = 495e12 / 3  # split TF32 on the tensor cores: three TF32 products a product
TOL_LOGITS = 1e-3   # relative to max |logit|, after 13 attention blocks
TOL_SCORE = 1e-4
# the incremental teacher's logits under bfloat16 autocast (K3, its inputs cast
# to f32) against the f32 plain version, of max |logit|: eight mantissa bits in
# every Linear of 18 blocks
TOL_AMP_LOGITS = 5e-2
# valid points of the smallest and the largest crop of the shipped training
# batch (16 crops in the 81,920 bucket; chip_smoke.py phase 5's rooms)
TRAIN_CROP = (58542, 69770)


class SmokeFailure(RuntimeError):
    pass


def expect(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def cuda_ms(fn, iters):
    """Mean milliseconds per call over ``iters`` calls after one warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device milliseconds per call over ``iters`` calls captured in
    one CUDA graph and replayed: the kernels' own time, without the host's
    time to issue them, which at small shapes is the larger."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def print_compiler_report(path):
    """Registers, shared memory and spills of every kernel, from the
    ``nvcc -Xptxas -v`` report kept beside the library; returns
    ``{kernel<args>: (registers, spill store bytes, spill load bytes)}``."""
    import re

    entry, spills, report = "?", "", {}
    with open(path) as f:
        for line in f:
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                # the mangled name holds the kernel's name behind its length
                # and its template arguments as Li<n>E
                names = re.findall(r"\d([a-z][a-z_]*[a-z])", found.group(1))
                entry = max(names, key=len) if names else found.group(1)[:48]
                args = re.findall(r"L[ib](\d+)E", found.group(1))
                entry += f"<{', '.join(args)}>" if args else ""
            elif "spill stores" in line:
                spills = line.strip()
            elif "Used" in line and "registers" in line:
                print(f"  {entry}: {line.strip().replace('ptxas info    : ', '')}; {spills}")
                regs = re.search(r"Used (\d+) registers", line)
                spill = [int(x) for x in re.findall(r"(\d+) bytes spill", spills)] or [0, 0]
                report[entry] = (int(regs.group(1)) if regs else -1, *spill[:2])
            elif "error" in line:
                print("  " + line.strip())
    return report


def expect_no_spill(compiled, name):
    """Fail unless ``name`` (a key of ``print_compiler_report``'s result)
    was built and spills no register; returns its registers."""
    regs, spill_st, spill_ld = compiled.get(name, (-1, -1, -1))
    expect(regs > 0 and spill_st == 0 and spill_ld == 0,
           f"{name}: {regs} registers, {spill_st} / {spill_ld} bytes spilled "
           "(stores / loads)")
    return regs


def bound(n_bytes, n_flops, t_ops=None):
    """The least time (ms) the card could take: the larger of the bytes
    moved once over the memory rate and the f32 operations over the
    non-tensor f32 peak (or ``t_ops``, the operations' least time where
    some run on another unit); and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    if t_ops is None:
        t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# inputs


def clustered_cloud(rng, B, N, valid):
    """(B, N, 3) room-scale clustered coords; sample b has ``valid[b]``
    real points first, then a masked tail of zeros (the padded layout)."""
    coord = np.zeros((B, N, 3), np.float32)
    for b in range(B):
        centers = rng.uniform(0, 8, size=(96, 3)) * [1.0, 1.0, 0.4]
        pick = rng.randint(0, len(centers), size=valid[b])
        pts = centers[pick] + rng.normal(scale=0.25, size=(valid[b], 3))
        coord[b, :valid[b]] = pts
    mask = np.arange(N)[None, :] < np.asarray(valid)[:, None]
    return coord, mask


def synthetic_room(rng, path, normals=False, density=700):
    """A 5 x 4 x 3 m office in the S3DIS layout (coord, color, semantic_gt,
    instance_gt): ceiling, floor, walls, window, door and board patches,
    and furniture boxes of the other classes, each plane and each box an
    instance of its own (18 in all); ``density`` raw points a square metre
    of surface (700: ~1.1 a 4 cm voxel).  With ``normals`` a ``normal``
    array too (each plane's unit normal).  The instance ids and normals
    draw nothing from ``rng``, so the room is the same with or without
    them."""
    parts = []
    instances = itertools.count()

    def plane(label, origin, u, v, instance=None):
        area = np.linalg.norm(u) * np.linalg.norm(v)
        n = int(area * density)
        a, b = rng.rand(n, 1), rng.rand(n, 1)
        pts = origin + a * u + b * v + rng.normal(scale=0.004, size=(n, 3))
        normal = np.cross(u, v) / area
        instance = next(instances) if instance is None else instance
        parts.append((pts, np.full(n, label), np.tile(normal, (n, 1)), np.full(n, instance)))

    def box(label, lo, hi):
        lo, hi = np.asarray(lo, float), np.asarray(hi, float)
        d = hi - lo
        instance = next(instances)
        for axis in range(3):
            u = np.eye(3)[(axis + 1) % 3] * d[(axis + 1) % 3]
            v = np.eye(3)[(axis + 2) % 3] * d[(axis + 2) % 3]
            for side in (0.0, 1.0):
                plane(label, lo + np.eye(3)[axis] * d[axis] * side, u, v, instance)

    X, Y, Z = ROOM
    plane(0, [0, 0, Z], [X, 0, 0], [0, Y, 0])                  # ceiling
    plane(1, [0, 0, 0], [X, 0, 0], [0, Y, 0])                  # floor
    for o, u in (([0, 0, 0], [X, 0, 0]), ([0, Y, 0], [X, 0, 0]),
                 ([0, 0, 0], [0, Y, 0]), ([X, 0, 0], [0, Y, 0])):
        plane(2, o, u, [0, 0, Z])                              # walls
    plane(5, [0.3 * X, 0.02, 0.33 * Z], [0.3 * X, 0, 0], [0, 0, 0.4 * Z])
    plane(6, [0.02, 0.6 * Y, 0], [0, 0.25 * Y, 0], [0, 0, 0.7 * Z])
    plane(11, [0.4 * X, Y - 0.02, 0.33 * Z], [0.4 * X, 0, 0], [0, 0, 0.4 * Z])
    box(3, [0, 0.48 * Y, 0.87 * Z], [X, 0.52 * Y, Z])           # beam
    box(4, [0.92 * X, 0, 0], [X, 0.1 * Y, Z])                  # column
    box(7, [0.3 * X, 0.3 * Y, 0.24 * Z], [0.6 * X, 0.58 * Y, 0.26 * Z])
    for cx in (0.32, 0.44, 0.56):                              # chairs
        box(8, [cx * X, 0.15 * Y, 0], [cx * X + 0.45, 0.15 * Y + 0.45, 0.3 * Z])
    box(9, [0.06 * X, 0.65 * Y, 0], [0.4 * X, 0.88 * Y, 0.27 * Z])  # sofa
    box(10, [0.76 * X, 0.85 * Y, 0], [0.98 * X, 0.98 * Y, 0.67 * Z])
    box(12, [0.72 * X, 0.12 * Y, 0], [0.86 * X, 0.25 * Y, 0.2 * Z])
    coord = np.concatenate([p for p, _, _, _ in parts]).astype(np.float32)
    label = np.concatenate([lbl for _, lbl, _, _ in parts]).astype(np.int64)
    color = (rng.rand(len(coord), 3) * 255).astype(np.float32)
    color[:, 0] = np.clip(color[:, 0] * 0.5 + label * 10, 0, 255)
    extra = ({"normal": np.concatenate([nrm for _, _, nrm, _ in parts]).astype(np.float32)}
             if normals else {})
    np.savez(path, coord=coord, color=color, semantic_gt=label,
             instance_gt=np.concatenate([i for _, _, _, i in parts]).astype(np.int64), **extra)
    return len(coord)


def randomise_bn(module, gen):
    """Random BatchNorm affines and running statistics, in place, so that
    the folding into affines is exercised."""
    import torch

    from pointcloudpdf_tpu_torch.models.norm import MaskedBatchNorm

    for bn in module.modules():
        if isinstance(bn, MaskedBatchNorm):
            c = bn.num_features
            with torch.no_grad():
                bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
                bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                bn.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
    return module


def random_jax_checkpoint(path, model, recognizer_model=None):
    """Seeded random weights (torch init, BatchNorm affines and running
    statistics randomised) written through the bridge as a JAX-layout
    checkpoint: the joint open-set layout with a recognizer, the plain
    closed-set one without."""
    import torch

    from pointcloudpdf_tpu_torch.bridge import state_dict_to_jax
    from pointcloudpdf_tpu_torch.utils.checkpoint import save_checkpoint

    gen = torch.Generator().manual_seed(SEED)
    tree = state_dict_to_jax(randomise_bn(model, gen).state_dict())
    if recognizer_model is not None:
        rec = state_dict_to_jax(randomise_bn(recognizer_model, gen).state_dict())
        tree = {coll: {"model": tree[coll], "recognizer": rec[coll]}
                for coll in ("params", "batch_stats")}
    save_checkpoint(path, {"epoch": 0, "state": tree})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def knn_cases(dev, rng):
    """K1's phase-3 cases at the main path's shapes: (name, query, ref, k,
    ref_mask, same), where ``same`` means the queries are the refs."""
    import torch

    from pointcloudpdf_tpu_torch.ops import sampling

    B, N = 2, N_MAIN
    coord, mask = clustered_cloud(rng, B, N, [N, N - N // 7])
    coord = torch.from_numpy(coord).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    sub = coord[:, : N // 4].contiguous()
    sub_mask = mask[:, : N // 4].contiguous()
    # the Stratified Transformer's first layer: 16384 points, its local keys
    # (k = 32) and its sparse keys (k = 16 of the N/8 FPS picks, masked)
    n1 = N // 4
    coord1, mask1 = clustered_cloud(rng, B, n1, [n1, n1 - n1 // 7])
    coord1 = torch.from_numpy(coord1).to(dev)
    mask1 = torch.from_numpy(mask1).to(dev)
    ds_idx, ds_valid = sampling.blocked_farthest_point_sampling(
        coord1, n1 // 8, mask1, max_group_steps=128)
    ds_coord = coord1.gather(1, ds_idx.long()[..., None].expand(-1, -1, 3))
    # a val-pass-sized set (the open-set configs crop val rooms at 800,000
    # points), from its own seed so that the other phases' inputs stay put
    big, big_mask = clustered_cloud(np.random.RandomState(SEED + 6), 1, N_VAL, [N_VAL])
    big = torch.from_numpy(big).to(dev)
    big_mask = torch.from_numpy(big_mask).to(dev)
    return [("self k=16", coord, coord, 16, mask, True),
            ("self k=8", coord, coord, 8, mask, True),
            ("cross N/4->N k=16", sub, coord, 16, mask, False),
            ("interp N->N/4 k=3", coord, sub, 3, sub_mask, False),
            (f"self k=32 N={n1}", coord1, coord1, 32, mask1, True),
            (f"sparse k=16 {n1}->{n1 // 8} masked", coord1, ds_coord, 16, ds_valid, False),
            (f"ball k=34 N={N}", coord, coord, 34, mask, True),
            (f"self k=16 N={N_VAL} B=1", big, big, 16, big_mask, True)]


def knn_brute_cases(dev):
    """K1a's phase-3 cases, the brute-force kernel at the main path's shapes
    and at its edges: (name, query, ref, k, ref_mask, same).  PT-v1 serving
    at B = 1 in the 65,536 bucket: a fragment's stages 3-5 (4,096 / 1,024 /
    256 points; a prefix of the seeded cloud stands for the FPS picks), the
    TransitionDown into stage 4 and the TransitionUp out of stage 3; the
    train step at B = 16 (crops spread over ``TRAIN_CROP`` in the 81,920
    bucket): stage 3 (5,120 a crop, partly masked) and the TransitionUp out
    of it into stage 2 (20,480).  From their own seed, so that the other
    phases' inputs stay put."""
    import torch

    rng = np.random.RandomState(SEED + 7)
    frag = torch.from_numpy(clustered_cloud(rng, 1, N_MAIN, [N_MAIN])[0]).to(dev)

    def stage(n):
        return frag[:, :n].contiguous(), torch.ones((1, n), dtype=torch.bool, device=dev)

    s3, m3 = stage(4096)
    s4, m4 = stage(1024)
    s5, m5 = stage(256)
    s2 = stage(16384)[0]
    crops = np.linspace(TRAIN_CROP[0], TRAIN_CROP[1], 16).astype(int)
    t2, t2_mask = (torch.from_numpy(a).to(dev) for a in clustered_cloud(
        rng, 16, 20480, train_stage_valid(crops, 1)))
    t3 = t2[:, :5120].contiguous()
    t3_mask = (torch.arange(5120, device=dev)[None, :]
               < torch.tensor(train_stage_valid(crops, 2), device=dev)[:, None])
    # edges: an all-masked sample beside one with fewer valid refs than k;
    # 512 points eight times over (exact ties everywhere); k = 32 and 64
    e, e_mask = (torch.from_numpy(a).to(dev) for a in clustered_cloud(
        rng, 3, 2048, [2048, 0, 5]))
    dup = s3[:, rng.permutation(4096) % 512].contiguous()
    return [("serve self k=16 N=4096 B=1", s3, s3, 16, m3, True),
            ("serve self k=16 N=1024 B=1", s4, s4, 16, m4, True),
            ("serve self k=16 N=256 B=1", s5, s5, 16, m5, True),
            ("serve cross 1024->4096 k=16 B=1", s4, s3, 16, m3, False),
            ("serve interp 16384->4096 k=3 B=1", s2, s3, 3, m3, False),
            ("train self k=16 N=5120 B=16", t3, t3, 16, t3_mask, True),
            ("train interp 20480->5120 k=3 B=16", t2, t3, 3, t3_mask, False),
            ("edge all-masked, 5 valid k=16 N=2048 B=3", e, e, 16, e_mask, True),
            ("edge duplicates x8 k=16 N=4096 B=1", dup, dup, 16, m3, True),
            ("edge k=32 N=4096 B=1", s3, s3, 32, m3, True),
            ("edge k=64 N=4096 B=1", s3, s3, 64, m3, True)]


def knn_bounds(q, r, k, m):
    """K1's bound for the work these inputs need, per the on-chip rule:
    coordinates, mask and outputs moved once, and 8 flop (3 sub, 3 mul, 2
    add) for each of the M*k pairs that any exact kNN evaluates; and, for
    the reader, the brute-force bound (every query against every valid ref
    of its sample) that the row had before."""
    B, M = q.shape[:2]
    n_bytes = B * (M + r.shape[1]) * 12 + B * r.shape[1] + 2 * B * M * k * 4
    pairs = float(M * m.sum())
    return bound(n_bytes, 8.0 * B * M * k), bound(n_bytes, 8 * pairs), n_bytes, pairs


def visited_share(q, r, k, m, same, chunk=None):
    """The share of the brute-force work (every query against every valid
    ref of its sample) that the pruned kernel did on these inputs: a visit
    of a chunk by a tile counts 32 x chunk pairs; and the most chunks a
    tile visited."""
    from pointcloudpdf_tpu_torch.ops import geometry

    chunk = chunk or geometry.knn_chunk(r.shape[1])
    visits = geometry.knn_pruned_cuda(q, r, k, m, same, visits=True, chunk=chunk)[2]
    pairs = float(visits.sum()) * geometry.KNN_TILE * chunk
    return pairs / max(float(q.shape[1] * m.sum()), 1.0), int(visits.max())


def check_knn(dev, rng):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda, geometry

    worst, rows = 0.0, []
    for name, q, r, k, m, same in knn_cases(dev, rng) + knn_brute_cases(dev):
        pruned = r.shape[1] >= geometry.KNN_PRUNE_MIN_REFS
        idx, d2 = geometry.knn(q, r, k, m)
        # the plain version once, timed: it takes up to seconds here
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with _cuda.plain_versions():
            start.record()
            pidx, pd2 = geometry.knn(q, r, k, m)
            end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        fin = torch.isfinite(d2)
        expect(torch.equal(d2, pd2), f"K1 {name}: dist2 bitwise equal")
        worst = max(worst, float((d2[fin] - pd2[fin]).abs().max()) if bool(fin.any()) else 0.0)
        diff = idx != pidx
        # where the indices differ the distances must be an exact tie:
        # the kernel's index really lies at the reported distance
        ref_pts = geometry.gather_rows(r, idx)
        true_d2 = ((ref_pts - q[:, :, None, :]) ** 2).sum(-1)
        expect(bool(((true_d2 - d2).abs()[fin & diff] <= 1e-6 * d2[fin & diff]
                     .clamp(min=1e-12)).all()),
               f"K1 {name}: idx equal except at {int(diff.sum())} exact ties")
        expect(bool((idx >= 0).all() and (idx < r.shape[1]).all()),
               f"K1 {name}: every index a row of the refs")
        # back to back through the wrapper (with the host's time to issue
        # each call), and the kernels alone (a CUDA graph of 5 calls)
        ms = cuda_ms(lambda: geometry.knn(q, r, k, m), 5)
        kernel_ms = graph_ms(lambda: geometry.knn(q, r, k, m), 5)
        share, most, lanes = 1.0, None, None
        if pruned:
            share, most = visited_share(q, r, k, m, same)
            with _cuda.plain_versions():
                plain_plan = geometry.knn_plan(q, r, m, same)
            expect(all(torch.equal(a, b) for a, b in zip(
                geometry.knn_plan(q, r, m, same), plain_plan)),
                f"K1 {name}: the prep kernels' plan equals the plain plan")
        else:
            lanes = geometry.knn_lanes(q.shape[0], q.shape[1])
        (bound_ms, bound_by), (brute_ms, _), n_bytes, pairs = knn_bounds(q, r, k, m)
        rows.append({"case": name, "kernel": "pruned" if pruned else "brute",
                     "ms": kernel_ms, "call_ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "brute_bound_ms": brute_ms,
                     "lanes": lanes, "visited_share": share, "most_chunks_a_tile": most})
        taken = (f"pruned, visited {share:.4f} of the pairs (a tile {most} chunks at most)"
                 if pruned else f"brute force, {lanes} lanes a query")
        print(f"  K1 {name} ({taken}): kernel {kernel_ms:.4f} ms, a call {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{n_bytes:.3e} bytes, M*k pairs x 8 flop), brute-force bound "
              f"{brute_ms:.4f} ms ({pairs:.3e} pairs)")
    result = {"rows": rows, "max_abs_err": worst}
    for kind, case in (("pruned", "self k=16"), ("brute", "serve interp 16384->4096 k=3 B=1")):
        row = next(row for row in rows if row["case"] == case)
        expect(row["kernel"] == kind, f"K1 {case} takes the {kind} kernel")
        result[kind] = dict(row, shape=case if kind == "brute" else f"{case}, B=2")
    return result


def check_fps(dev, rng, compiled):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda, sampling

    for name in ("fps_kernel", *(f"fps_windows_kernel<{ppl}>" for ppl in (8, 16, 32))):
        expect_no_spill(compiled, name)
    rows, worst = [], 0
    B, N = 2, N_EXACT
    m = N // 4
    coord, mask = clustered_cloud(rng, B, N, [N, N - N // 7])
    coord = torch.from_numpy(coord).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    got = sampling.fps_sets(coord, mask, m)
    with _cuda.plain_versions():
        want = sampling.fps_sets(coord, mask, m)
    worst = max(worst, int((got - want).abs().max()))
    expect(torch.equal(got, want), f"K2 exact N={N} m={m}: indices equal")
    ms = cuda_ms(lambda: sampling.fps_sets(coord, mask, m), 3)
    with _cuda.plain_versions():
        plain_ms = cuda_ms(lambda: sampling.fps_sets(coord, mask, m), 1)
    rows.append((f"exact N={N} m={m}", ms, plain_ms))
    # bound of the exact case: each of the m rounds scans the N points once
    # (8 flop a distance, a min and a compare); coords and mask read once,
    # m indices written
    exact_flops, exact_bytes = B * N * m * 10, B * N * 13 + B * m * 4
    exact_bound, exact_by = bound(exact_bytes, exact_flops)
    print(f"  K2 exact N={N} m={m}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{exact_bound:.4f} ms ({exact_by}: {exact_flops:.3e} flop, {exact_bytes:.3e} "
          f"bytes; the {m} rounds are sequential)")

    # blocked, at the three window shapes of the paths (B = 2)
    result = None
    for i, (name, N, m, steps) in enumerate(FPS_WINDOW_CASES):
        G, g, k_g = sampling.window_shape(N, m, None, steps)
        # the ST cases from seeds of their own, so that the later checks'
        # inputs stay put
        coord, mask = clustered_cloud(rng if i == 0 else np.random.RandomState(SEED + i),
                                      B, N, [N, N - N // 7])
        coord = torch.from_numpy(coord).to(dev)
        mask = torch.from_numpy(mask).to(dev)

        def blocked():
            return sampling.blocked_farthest_point_sampling(
                coord, m, mask, max_group_steps=steps)

        idx, valid = blocked()
        with _cuda.plain_versions():
            pidx, pvalid = blocked()
        worst = max(worst, int((idx - pidx).abs().max()))
        case = f"{name}: N={N} m={m} ({B * G} windows of {g} x {k_g})"
        expect(torch.equal(idx, pidx) and torch.equal(valid, pvalid),
               f"K2 blocked {case}: indices and flags equal")
        # the windows kernel alone on the sorted samples the blocked call
        # hands it (a CUDA graph of calls: the kernel's own time), and the
        # whole blocked call (morton sort, gathers, duplicate flags and K2)
        order = sampling.morton_sort_indices(coord, mask)
        sorted_coord = coord.gather(1, order[..., None].expand(B, N, 3)).contiguous()
        count = mask.sum(1, dtype=torch.int32)
        pos = sampling.fps_windows(sorted_coord, count, G, g, k_g)
        with _cuda.plain_versions():
            ppos = sampling.fps_windows(sorted_coord, count, G, g, k_g)
        expect(torch.equal(pos, ppos), f"K2 windows {case}: positions equal")
        ms = graph_ms(lambda: sampling.fps_windows(sorted_coord, count, G, g, k_g), 10)
        wrapper_ms = cuda_ms(blocked, 5)
        with _cuda.plain_versions():
            plain_ms = cuda_ms(lambda: sampling.fps_windows(sorted_coord, count, G, g, k_g), 2)
        # bound: each of the k_g rounds of a window scans its g points once
        # (8 flop a distance, a min and a compare); the sorted coordinates
        # and the counts read once, the positions written once.  Floor of
        # the dependent rounds: tools/fps_compare_torch.py
        n_flops = B * G * g * k_g * 10
        n_bytes = B * N * 12 + B * 4 + B * m * 8
        bound_ms, bound_by = bound(n_bytes, n_flops)
        rows.append((f"blocked {case}", ms, plain_ms))
        print(f"  K2 windows {case}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}: {n_flops:.3e} flop, {n_bytes:.3e} bytes; "
              f"{k_g} sequential rounds); the blocked call {wrapper_ms:.3f} ms")
        if result is None:  # the main path's shape: PT-v1's windows
            result = {"ms": ms, "plain_ms": plain_ms, "wrapper_ms": wrapper_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "shape": f"blocked, B=2 x N={N}, m={m}: {B * G} windows of "
                               f"{g} points x {k_g} picks"}
    return dict(result, max_abs_err=float(worst), rows=rows)


def attention_inputs(dev, rng, N, C, K, drop=0.0, grad=False, valid=None):
    """Inputs of the vector-attention entries at one stage's shape: a
    clustered cloud with a masked tail (B = 2 and ``[N, N - N // 7]`` valid
    points unless ``valid`` gives one count a sample), its kNN table
    (``drop`` of the valid slots masked too), random features, weights and
    affines."""
    import torch

    from pointcloudpdf_tpu_torch.ops import geometry

    valid = [N, N - N // 7] if valid is None else list(valid)
    B, G = len(valid), C // 8
    coord, mask = clustered_cloud(rng, B, N, valid)
    coord = torch.from_numpy(coord).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    idx, d2 = geometry.knn(coord, coord, K, mask)
    nmask = torch.isfinite(d2) & mask[..., None]
    if drop:
        nmask &= torch.from_numpy(rng.rand(B, N, K) >= drop).to(dev)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(dev).requires_grad_(grad)

    feats = [t(B, N, C) for _ in range(3)]
    params = [t(3, 3, scale=0.5), t(3, scale=0.1), t(3, C, scale=0.5),
              t(C, scale=0.1), t(C, G, scale=C ** -0.5), t(G, scale=0.1),
              t(G, G, scale=G ** -0.5), t(G, scale=0.1),
              (1 + 0.1 * t(3)).detach().requires_grad_(grad), t(3, scale=0.1),
              (1 + 0.1 * t(C)).detach().requires_grad_(grad), t(C, scale=0.1),
              (1 + 0.1 * t(G)).detach().requires_grad_(grad), t(G, scale=0.1)]
    return feats, coord, idx, nmask, params


def attention_bound(B, N, C, K, pairs, backward):
    """Bound of the fused attention at one shape.  Bytes: the forward reads
    x_q, x_k, x_v and writes out; the backward reads x_q, x_k, x_v and dout
    and writes d x_q, d x_k, d x_v (it never reads out): 4 and 7 tensors of
    B*N*C*4, besides coord, idx, nmask and the packed parameters (the
    backward also writes their gradients).  Operations, per valid (query,
    neighbour) pair: the chain is 2*(9 + 3C + C*G + G*G) + 10C flop; the
    backward must recompute it once and run the two transposed products of
    each matrix, three times the chain (a second recompute sweep is this
    kernel's choice, not the function's)."""
    G = C // 8
    n_params = 18 + 6 * C + G * C + 3 * G + G * G + G
    tensors = 7 if backward else 4
    n_bytes = (tensors * B * N * C * 4 + B * N * 12 + B * N * K * 5
               + n_params * 4 * (2 if backward else 1))
    chain = 2 * (9 + 3 * C + C * G + G * G) + 10 * C
    return n_bytes, chain * pairs * (3 if backward else 1)


def attention_fwd_ops_ms(C, pairs):
    """The least time (ms) of the forward's operations in
    ``attention_bound``: its C x G and G x G products (2 (C G + G^2) flop a
    pair) at the split-TF32 rate of the tensor cores, where the kernel runs
    them, overlapping the rest at the f32 peak."""
    G = C // 8
    products = 2 * (C * G + G * G) * pairs
    rest = (2 * (9 + 3 * C) + 10 * C) * pairs
    return max(products / TF32_SPLIT_FLOPS, rest / F32_FLOPS) * 1e3


def attention_bwd_ops_ms(C, pairs):
    """The least time (ms) of the backward's operations in
    ``attention_bound``: its C x G and G x G products (2 (C G + G^2) flop a
    pair and pass) at the split-TF32 rate of the tensor cores, where the
    kernel runs them, overlapping the rest at the f32 peak."""
    G = C // 8
    products = 3 * 2 * (C * G + G * G) * pairs
    rest = 3 * (2 * (9 + 3 * C) + 10 * C) * pairs
    return max(products / TF32_SPLIT_FLOPS, rest / F32_FLOPS) * 1e3


def train_stage_valid(crops, stage):
    """Valid points a sample at a Seg50 stage (0-4) of a training batch of
    ``crops``: each stage keeps a quarter of the points, rounded up."""
    return [-(-int(v) // 4 ** stage) for v in crops]


def attention_train_shapes(crops):
    """(name, N, C, K, valid) of the five attention stages of a Seg50 train
    step on a batch of ``crops`` (B = 16 in the 81,920 bucket): every stage
    a quarter of the points of the one before."""
    return [(f"train stage-{s + 1} B=16 C={C} K={K}", 81920 >> (2 * s), C, K,
             train_stage_valid(crops, s))
            for s, (C, K) in enumerate(((32, 8), (64, 16), (128, 16), (256, 16), (512, 16)))]


def check_attention(dev, rng, compiled):
    """K3 against ``vector_attention_plain`` at two serving stages' shapes
    (B = 2) and at the five stages of the train step (B = 16 crops, from a
    seed of their own), the bound counting the C x G and G x G products at
    the split-TF32 rate; no instantiation of the forward or the backward
    kernel may spill registers."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops.vector_attention import _WIDTHS, vector_attention

    for kernel in ("attn_kernel", "attn_bwd_kernel"):
        for width in _WIDTHS:
            expect_no_spill(compiled, f"{kernel}<{width}>")
    train_rng = np.random.RandomState(SEED + 9)
    crops = train_rng.randint(TRAIN_CROP[0], TRAIN_CROP[1] + 1, size=16)
    cases = [("stage-1 C=32 K=8", N_MAIN, 32, 8, None),
             ("stage-4 C=256 K=16", N_MAIN // 64, 256, 16, None),
             *attention_train_shapes(crops)]
    rows, worst = [], 0.0
    for name, N, C, K, valid in cases:
        feats, coord, idx, nmask, params = attention_inputs(
            dev, rng if valid is None else train_rng, N, C, K, valid=valid)
        B = len(feats[0])

        def run():
            return vector_attention(*feats, coord, idx, nmask, *params)

        with torch.inference_mode():
            out = run()
            with _cuda.plain_versions():
                ref = run()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            worst = max(worst, err / scale)
            expect(err <= TOL_K3 * scale,
                   f"K3 {name}: max abs err {err:.3e} <= {TOL_K3} x {scale:.3e}")
            ms = cuda_ms(run, 10)
            with _cuda.plain_versions():
                plain_ms = cuda_ms(run, 3 if valid is None else 2)
            del out, ref
        pairs = float(nmask.sum())
        n_bytes, n_flops = attention_bound(B, N, C, K, pairs, False)
        bound_ms, bound_by = bound(n_bytes, n_flops, attention_fwd_ops_ms(C, pairs))
        regs = compiled[f"attn_kernel<{C}>"][0]
        rows.append((name, ms, plain_ms, bound_ms, bound_by, regs))
        print(f"  K3 {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {n_bytes:.3e} bytes, {n_flops:.3e} flop "
              f"over {pairs:.3e} valid pairs; products at 495/3 TFLOP/s); "
              f"{regs} registers, no spill")
        del feats, coord, idx, nmask, params
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": rows[0][1], "plain_ms": rows[0][2],
            "bound_ms": rows[0][3], "bound_by": rows[0][4],
            "shape": f"stage-1, B=2 x N={N_MAIN}, C=32, K=8; "
                     "max_abs_err is relative to max |plain|", "rows": rows}


K4_LEAVES = ["x_q", "x_k", "x_v", "p1_w", "p1_b", "p2_w", "p2_b", "w1_w", "w1_b",
             "w2_w", "w2_b", "bnp_scale", "bnp_shift", "bnw1_scale",
             "bnw1_shift", "bnw2_scale", "bnw2_shift"]


def compare_attention_train(name, feats, coord, idx, nmask, params, dout):
    """K4 against the plain version's autograd on one set of inputs (leaf
    tensors with requires_grad), with the pairs on a ReLU kink masked off
    on both sides.  Returns the worst relative errors, the run to time and
    the mask."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import vector_attention as va

    cleared = va.mask_off_relu_kinks(*feats, coord, idx, nmask, *params)
    leaves = [*feats, *params]

    def run():
        out = va.vector_attention_train(*feats, coord, idx, cleared, *params)
        return out.detach(), torch.autograd.grad(out, leaves, dout)

    out, grads = run()
    with _cuda.plain_versions():
        ref, rgrads = run()
    torch.cuda.synchronize()
    worst = {"forward": float((out - ref).abs().max()) / float(ref.abs().max()),
             "x": 0.0, "param": 0.0}
    expect(worst["forward"] <= TOL_K4_X,
           f"K4 {name}: forward rel err {worst['forward']:.3e} <= {TOL_K4_X} "
           f"({int(nmask.sum() - cleared.sum())} of {int(nmask.sum())} pairs on a "
           "ReLU kink masked off)")
    rel = dict(zip(K4_LEAVES, rgrads))
    for i, (key, g, r) in enumerate(zip(K4_LEAVES, grads, rgrads)):
        # w2_b's exact gradient is 0 (a softmax ignores a shift of its
        # logits): both sides hold rounding noise, held to w2_w's scale
        gscale = float(rel["w2_w" if key == "w2_b" else key].abs().max())
        kind, tol = ("x", TOL_K4_X) if i < 3 else ("param", TOL_K4_PARAM)
        err = float((g - r).abs().max()) / gscale
        worst[kind] = max(worst[kind], err)
        if err > tol:
            raise SmokeFailure(f"K4 {name}: d {key} rel err {err:.3e} > {tol}")
    print(f"  ok: K4 {name}: d x rel err {worst['x']:.3e} <= {TOL_K4_X}, d params "
          f"{worst['param']:.3e} <= {TOL_K4_PARAM}")
    return worst, run, cleared


def check_attention_train(dev, rng):
    """K4 (training forward + backward) against the plain version's
    autograd at three stages' shapes, B = 2, ~5% of the neighbour slots and
    a tail of rows masked; then at the train step's shapes of stages 4 and
    5 (B = 16 crops, K = 16), from a seed of their own."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda

    train_rng = np.random.RandomState(SEED + 7)
    crops = train_rng.randint(TRAIN_CROP[0], TRAIN_CROP[1] + 1, size=16)
    cases = [("stage-1 C=32 K=8", N_MAIN, 32, 8, None),
             ("stage-4 C=256 K=16", N_MAIN // 64, 256, 16, None),
             ("stage-5 C=512 K=16", N_MAIN // 256, 512, 16, None),
             ("train stage-4 B=16 C=256 K=16", 1280, 256, 16, train_stage_valid(crops, 3)),
             ("train stage-5 B=16 C=512 K=16", 320, 512, 16, train_stage_valid(crops, 4))]
    rows, worst = [], {"forward": 0.0, "x": 0.0, "param": 0.0}
    for name, N, C, K, valid in cases:
        r = rng if valid is None else train_rng
        feats, coord, idx, nmask, params = attention_inputs(
            dev, r, N, C, K, drop=0.05 if valid is None else 0.0, grad=True,
            valid=valid)
        B = len(feats[0])
        dout = torch.from_numpy(
            r.standard_normal((B, N, C)).astype(np.float32)).to(dev)
        errs, run, cleared = compare_attention_train(
            name, feats, coord, idx, nmask, params, dout)
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
        ms = cuda_ms(run, 5)
        with _cuda.plain_versions():
            plain_ms = cuda_ms(run, 2)
        pairs = float(cleared.sum())
        fb, ff = attention_bound(B, N, C, K, pairs, False)
        bb, bf = attention_bound(B, N, C, K, pairs, True)
        t_ops = attention_fwd_ops_ms(C, pairs) + attention_bwd_ops_ms(C, pairs)
        bound_ms, bound_by = bound(fb + bb, ff + bf, t_ops)
        peak = "products at 495/3 TFLOP/s, the rest at 67"
        rows.append((name, ms, plain_ms, bound_ms, bound_by, peak))
        print(f"  K4 {name} forward+backward: kernels {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {fb + bb:.3e} bytes, "
              f"{ff + bf:.3e} flop; {peak})")
    print(f"  K4 worst rel err: forward {worst['forward']:.3e}, d x {worst['x']:.3e}, "
          f"d params {worst['param']:.3e}")
    return {"max_abs_err": max(worst.values()), "ms": rows[0][1],
            "plain_ms": rows[0][2], "bound_ms": rows[0][3], "bound_by": rows[0][4],
            "shape": f"stage-1 forward+backward, B=2 x N={N_MAIN}, C=32, K=8; "
                     "max_abs_err is relative to each tensor's max",
            "rows": rows}


def st_attention_inputs(dev, rng, N, C, K=48, window=0.32, quant=0.02):
    """Inputs of the cRPE window attention at one layer's shape, B = 2: a
    clustered cloud with a masked tail, the K nearest points as keys with
    ~20% of the slots masked and every 97th query left with none, random
    q/k/v and tables."""
    import torch

    from pointcloudpdf_tpu_torch.ops import geometry

    B = 2
    coord, mask = clustered_cloud(rng, B, N, [N, N - N // 7])
    coord = torch.from_numpy(coord).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    key_idx, d2 = geometry.knn(coord, coord, K, mask)
    key_mask = torch.isfinite(d2) & mask[..., None]
    key_mask &= torch.from_numpy(rng.rand(B, N, K) >= 0.2).to(dev)
    key_mask[:, ::97] = False
    num_bins = 2 * int((2 * window + 1e-4) // quant)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    q, k, v = (t(B, N, C) for _ in range(3))
    tables = [t(3, num_bins, C, scale=0.3) for _ in range(3)]
    return (q, k, v, coord, key_idx, key_mask, *tables, C // 16, window, quant,
            num_bins)


def st_attention_kernel_bins(coord, key_idx, window, quant, num_bins, C):
    """The bins (B, N, K, 3) int64 that K5 picks at width C, read back
    through the kernel itself: with zero q, k and v, one key slot valid a
    launch and a value table whose row r holds r in the channel of its axis
    in every head, the output at (query, channel a) is the bin of axis a."""
    import torch

    from pointcloudpdf_tpu_torch.ops import st_attention as sa

    B, N, K = key_idx.shape
    dev = coord.device
    zeros = torch.zeros((B, N, C), device=dev)
    probe = torch.zeros((3, num_bins, C), device=dev)
    for axis in range(3):
        probe[axis, :, axis::16] = torch.arange(num_bins, device=dev)[:, None]
    bins = torch.empty((B, N, K, 3), dtype=torch.long, device=dev)
    with torch.inference_mode():
        for slot in range(K):
            only = torch.zeros((B, N, K), dtype=torch.bool, device=dev)
            only[..., slot] = True
            out = sa.st_attention(zeros, zeros, zeros, coord, key_idx, only, None,
                                  None, probe, C // 16, window, quant, num_bins)
            heads = out.reshape(B, N, C // 16, 16)[..., :3]
            if not bool((heads == heads[:, :, :1]).all()):
                raise AssertionError("K5: the heads of one query picked different bins")
            bins[:, :, slot] = heads[:, :, 0].round().long()
    return bins


# K5's phase-3 shapes (C, N, window, quant, K, tables on: tq, tk, tv, launches
# an ST forward): the three layer shapes of the shipped S3DIS config, the
# module's defaults (rel_key = rel_value = False) at layer 2's shape, and
# layer 1 at the kernel's most key slots
ST_CASES = ((96, 16384, 0.32, 0.02, 48, (True, True, True), 2),
            (192, 4096, 0.64, 0.04, 48, (True, True, True), 6),
            (384, 1024, 1.28, 0.08, 48, (True, True, True), 2),
            (192, 4096, 0.64, 0.04, 48, (True, False, False), 0),
            (96, 16384, 0.32, 0.02, 64, (True, True, True), 0))


def st_attention_case(dev, rng, case):
    """(name, the wrapper's arguments) of one ``ST_CASES`` entry, B = 2."""
    C, N, window, quant, K, tables, _ = case
    args = list(st_attention_inputs(dev, rng, N, C, K=K, window=window, quant=quant))
    for i, on in enumerate(tables):
        if not on:
            args[6 + i] = None
    terms = "".join("qkv"[i] if on else "-" for i, on in enumerate(tables))
    return f"C={C} H={C // 16} N={N} K={K} 2L={args[-1]} tables {terms}", args


def st_attention_bound(B, N, C, K, num_bins, pairs, tables):
    """(bytes, flop) of the cRPE window attention.  Bytes: q, k, v, coord,
    key_idx, key_mask and the tables that are on read once, out written
    once.  Operations a valid (query, key) pair: the q . k dots of the
    heads (2C); per table on, the sum of its three rows and the dot (4C)
    for tq and tk, the sum and the add to v (3C) for tv; the weighted sum
    (2C); a softmax step a head (6H); three bins (15)."""
    on = sum(tables)
    n_bytes = 4 * B * N * C * 4 + B * N * 12 + B * N * K * 5 + on * 3 * num_bins * C * 4
    per_pair = 4 * C + 4 * C * tables[0] + 4 * C * tables[1] + 3 * C * tables[2]
    return n_bytes, pairs * (per_pair + 6 * (C // 16) + 15)


def check_st_attention(dev, rng, compiled):
    """K5 against ``st_attention_plain`` at ``ST_CASES``: identical bins,
    output within TOL_K5 of max |plain|, queries without a key at 0; the
    kernel's own time from a CUDA graph, the wrapper's beside it; no spill
    in ``st_attention_kernel``."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import st_attention as sa

    regs = expect_no_spill(compiled, "st_attention_kernel")
    rows, worst = [], 0.0
    # the two probes past the layer shapes draw from a seed of their own, so
    # the kernels checked after K5 see the inputs they saw before
    probes = np.random.RandomState(SEED + 5)
    for i, case in enumerate(ST_CASES):
        name, args = st_attention_case(dev, rng if i < 3 else probes, case)
        C, N, window, quant, K, tables, launches = case
        coord, key_idx, key_mask, num_bins = args[3], args[4], args[5], args[-1]
        B, H = 2, C // 16
        expect(num_bins == 64, f"K5 {name}: 64 rows a table")
        bins = st_attention_kernel_bins(coord, key_idx, window, quant, num_bins, C)
        want = sa.st_attention_bins(coord, key_idx, window, quant, num_bins)
        differing = int((bins != want).sum())
        expect(differing == 0 and len(torch.unique(want)) > 16,
               f"K5 {name}: bins identical at all {want.numel()} (query, key, "
               f"axis), {len(torch.unique(want))} distinct")

        def run():
            return sa.st_attention(*args)

        with torch.inference_mode():
            out = run()
            with _cuda.plain_versions():
                ref = run()
            torch.cuda.synchronize()
            err, scale = float((out - ref).abs().max()), float(ref.abs().max())
            worst = max(worst, err / scale)
            expect(err <= TOL_K5 * scale,
                   f"K5 {name}: max abs err {err:.3e} <= {TOL_K5} x {scale:.3e}")
            expect(bool((out[:, ::97] == 0).all()), f"K5 {name}: queries without a key give 0")
            ms = graph_ms(run, 10)
            wrapper_ms = cuda_ms(run, 10)
            with _cuda.plain_versions():
                plain_ms = cuda_ms(run, 3)
        pairs = float(key_mask.sum())
        n_bytes, n_flops = st_attention_bound(B, N, C, K, num_bins, pairs, tables)
        bound_ms, bound_by = bound(n_bytes, n_flops)
        rows.append((name, ms, plain_ms, bound_ms, bound_by, wrapper_ms, launches, regs))
        print(f"  K5 {name}: kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f}), plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_bytes:.3e} "
              f"bytes, {n_flops:.3e} flop over {pairs:.3e} valid pairs), {launches} "
              f"launches an ST forward, {regs} registers")
    return {"max_abs_err": worst, "ms": rows[0][1], "plain_ms": rows[0][2],
            "bound_ms": rows[0][3], "bound_by": rows[0][4], "wrapper_ms": rows[0][5],
            "shape": "layer 1, B=2 x N=16384, C=96, H=6, K=48, 2L=64; "
                     "max_abs_err is relative to max |plain|", "rows": rows}


# K6's phase-3 shapes (C_in, C_out): the S3DIS ST stem's two KPConvs
KPCONV_SHAPES = ((6, 48), (12, 12))


def kpconv_table(dev, rng, B=2, N=N_MAIN, S=34, radius=0.10, sigma_r=0.04):
    """K6's inputs but for the features and weights: (coord, mask, idx,
    nmask, kernel points, sigma_r), over the S nearest points of a 0.10 m
    ball (K1 + the radius cut)."""
    import torch

    from pointcloudpdf_tpu_torch.models.stratified_transformer.st import (
        kpconv_kernel_points)
    from pointcloudpdf_tpu_torch.ops import geometry

    coord, mask = clustered_cloud(rng, B, N, [N, N - N // 7])
    # shrunk, so that a ball holds what a room at 4 cm voxels gives it (some
    # 20 points, many balls full) and not the ~6 of the room-scale cloud
    coord = torch.from_numpy(coord * np.float32(0.6)).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    idx, nmask = geometry.ball_query(coord, coord, radius, S, ref_mask=mask)
    nmask = nmask & mask[..., None]
    points = torch.from_numpy(
        kpconv_kernel_points() * np.float32(1.5 * sigma_r)).to(dev)
    return coord, mask, idx, nmask, points, sigma_r


def kpconv_weights(dev, rng, B, N, P, c_in, c_out):
    import torch

    feat = torch.from_numpy(
        rng.standard_normal((B, N, c_in)).astype(np.float32)).to(dev)
    weight = torch.from_numpy(
        (rng.standard_normal((P, c_in, c_out)) * 0.2).astype(np.float32)).to(dev)
    return feat, weight


def kpconv_bound(nmask, B, N, S, P, c_in, c_out):
    """Bytes: coord, feat, idx, nmask, the kernel points and W read once,
    out written once.  Operations: a valid pair takes 12 P for its
    influences (3 sub, 3 mul, 2 add, sqrt, div, sub, max a kernel point) and
    2 P C_in for the weighted features; a point with a neighbour 2 P C_in
    C_out for the product with W.  -> (bytes, flop, ms, by, pairs)."""
    pairs, pts = float(nmask.sum()), float(nmask.any(-1).sum())
    n_bytes = (B * N * (12 + 4 * c_in + 5 * S + 4 * c_out)
               + P * 12 + P * c_in * c_out * 4)
    n_flops = pairs * (12 * P + 2 * P * c_in) + pts * 2 * P * c_in * c_out
    return (n_bytes, n_flops, *bound(n_bytes, n_flops), pairs)


def check_kpconv(dev, rng, compiled):
    """K6 against ``kpconv_plain`` at the two stem shapes, N = 65536."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import kpconv as kp

    for nt in (1, 2):
        expect_no_spill(compiled, f"kpconv_kernel<{nt}>")
    B, N, S = 2, N_MAIN, 34
    coord, mask, idx, nmask, points, sigma_r = kpconv_table(dev, rng, B, N, S)
    counts = nmask.sum(-1)[mask]
    print(f"  K6 neighbour table: {float(counts.float().mean()):.1f} of {S} slots "
          f"valid a point, {float((counts == S).float().mean()):.3f} of the balls full")
    P = points.shape[0]
    rows, worst = [], 0.0
    for c_in, c_out in KPCONV_SHAPES:
        feat, weight = kpconv_weights(dev, rng, B, N, P, c_in, c_out)

        def run():
            return kp.kpconv(coord, feat, idx, nmask, points, weight, sigma_r)

        name = f"{c_in}->{c_out} N={N} S={S} P={P}"
        with torch.inference_mode():
            out = run()
            with _cuda.plain_versions():
                ref = run()
            torch.cuda.synchronize()
            err, scale = float((out - ref).abs().max()), float(ref.abs().max())
            worst = max(worst, err / scale)
            expect(err <= TOL_K6 * scale,
                   f"K6 {name}: max abs err {err:.3e} <= {TOL_K6} x {scale:.3e}")
            expect(bool((out[~mask] == 0).all()), f"K6 {name}: padded rows give 0")
            ms = graph_ms(run, 10)
            wrapper_ms = cuda_ms(run, 10)
            with _cuda.plain_versions():
                plain_ms = cuda_ms(run, 3)
        n_bytes, n_flops, bound_ms, bound_by, pairs = kpconv_bound(
            nmask, B, N, S, P, c_in, c_out)
        rows.append((name, ms, plain_ms, bound_ms, bound_by, wrapper_ms))
        print(f"  K6 {name}: kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f}), plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_bytes:.3e} "
              f"bytes, {n_flops:.3e} flop over {pairs:.3e} valid pairs)")
    return {"max_abs_err": worst, "ms": rows[0][1], "plain_ms": rows[0][2],
            "bound_ms": rows[0][3], "bound_by": rows[0][4], "wrapper_ms": rows[0][5],
            "shape": f"stem 6->48, B=2 x N={N}, S=34, P=15; "
                     "max_abs_err is relative to max |plain|", "rows": rows}


def gva_bound(B, N, C, G, S, pairs, branches):
    """Bound of the grouped vector attention at one shape.  Bytes: q, k, v
    and coord read once, out written once, idx and nmask (5 bytes a slot),
    the parameters.  Operations a valid (query, neighbour) pair, counted
    from the code: each positional encoding that is on 6C (3 -> C), 4C (BN,
    ReLU, bias) and 2C^2 (C -> C); the weight encoding 2CG + 2G^2 + 4G; the
    relation, the softmax and the aggregation 6C + 5G."""
    n_params = 14 * C + 4 * G + G * G + G * C + branches * C * C
    n_bytes = 4 * B * N * C * 4 + B * N * 12 + B * N * S * 5 + n_params * 4
    per_pair = (branches * (6 * C + 2 * C * C + 4 * C)
                + 2 * C * G + 2 * G * G + 4 * G + 6 * C + 5 * G)
    return n_bytes, pairs * per_pair


def gva_ops_ms(C, pairs, branches):
    """The least time (ms) of ``gva_bound``'s operations with the products
    where K7 runs them: the 2 C^2 of each positional encoding that is on and
    the weight encoding's 2 C G at the split-TF32 rate of the tensor cores,
    overlapping the rest at the f32 peak."""
    G = C // 8
    products = (branches * 2 * C * C + 2 * C * G) * pairs
    rest = (branches * (6 * C + 4 * C) + 2 * G * G + 4 * G + 6 * C + 5 * G) * pairs
    return max(products / TF32_SPLIT_FLOPS, rest / F32_FLOPS) * 1e3


# K7's phase-3 shapes (N, C, (pe_multiplier, pe_bias)), B = 2: the S3DIS
# PT-v2m2 path's four widths (patch embedding and decoder 1 at C = 48,
# stage 1 and decoder 2 at 96, stage 2 and decoder 3 at 192, stage 3 at 384)
# and the ScanNet PT-v2m2 config's fourth stage (C = 512), pe_bias as
# PT-v2m2; then two probes of the other branch combinations
GVA_CASES = ((65536, 48, (False, True)), (16384, 96, (False, True)),
             (16384, 192, (False, True)), (8192, 384, (False, True)),
             (2048, 512, (False, True)), (16384, 96, (True, False)),
             (16384, 96, (True, True)))


def gva_case_name(N, C, pe, S):
    branch = {(False, True): "pe_bias", (True, False): "pe_multiplier",
              (True, True): "both"}[pe]
    return f"C={C} G={C // 8} N={N} S={S} {branch}"


def gva_inputs(dev, rng, N, C, pe, S=16):
    """Inputs of the grouped vector attention at one stage's shape, B = 2: a
    clustered cloud with a masked tail (query-invalid rows), its kNN table
    with ~10% of the valid slots masked and every 97th query left with
    none, random q/k/v, and an eval attention module of width C (random
    weights, BatchNorm affines and running statistics)."""
    import torch

    from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2
    from pointcloudpdf_tpu_torch.ops import geometry

    B = 2
    coord, mask = clustered_cloud(rng, B, N, [N, N - N // 7])
    coord = torch.from_numpy(coord).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    idx, d2 = geometry.knn(coord, coord, S, mask)
    nmask = torch.isfinite(d2) & mask[..., None]
    nmask &= torch.from_numpy(rng.rand(B, N, S) >= 0.1).to(dev)
    nmask[:, ::97] = False
    torch.manual_seed(SEED + C)
    attn = ptv2.GroupedVectorAttention(C, C // 8, pe_multiplier=pe[0], pe_bias=pe[1])
    attn = randomise_bn(attn, torch.Generator().manual_seed(SEED + C)).to(dev).eval()
    q, k, v = (torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(dev)
               for _ in range(3))
    return (q, k, v, coord, idx, nmask, attn.linear_p_multiplier, attn.linear_p_bias,
            attn.weight_encoding, C // 8), mask


def check_gva(dev, rng, compiled):
    """K7 against ``gva_plain`` at ``GVA_CASES``, each row with its
    launches in a PT-v2m2 S3DIS forward (``PTV2_K7_BY_WIDTH``, which phase
    8 asserts), its bound (products at the split-TF32 rate) and its
    instantiation's registers and spills (``compiled``: the compiler
    report); no instantiation may spill."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import gva

    for width in gva._WIDTHS:
        for mul in (0, 1):  # the multiplier encoding off / on
            expect_no_spill(compiled, f"gva_kernel<{width}, {mul}>")
    rows, worst = [], 0.0
    for N, C, pe in GVA_CASES:
        args, mask = gva_inputs(dev, rng, N, C, pe)
        B, G, S = 2, C // 8, args[4].shape[-1]
        name = gva_case_name(N, C, pe, S)

        def run():
            return gva.grouped_vector_attention(*args)

        with torch.inference_mode():
            out = run()
            with _cuda.plain_versions():
                ref = run()
            torch.cuda.synchronize()
            err, scale = float((out - ref).abs().max()), float(ref.abs().max())
            worst = max(worst, err / scale)
            expect(err <= TOL_K7 * scale,
                   f"K7 {name}: max abs err {err:.3e} <= {TOL_K7} x {scale:.3e}")
            expect(bool((out[:, ::97] == 0).all()) and bool((out[~mask] == 0).all()),
                   f"K7 {name}: queries without a neighbour and invalid queries give 0")
            ms = cuda_ms(run, 5)
            with _cuda.plain_versions():
                plain_ms = cuda_ms(run, 2)
        pairs = float(args[5].sum())
        n_bytes, n_flops = gva_bound(B, N, C, G, S, pairs, pe[0] + pe[1])
        bound_ms, bound_by = bound(n_bytes, n_flops, gva_ops_ms(C, pairs, pe[0] + pe[1]))
        launches = PTV2_K7_BY_WIDTH.get(C, 0) if pe == (False, True) else 0
        regs = compiled[f"gva_kernel<{C}, {int(pe[0])}>"][0]
        rows.append((name, ms, plain_ms, bound_ms, bound_by, launches, regs))
        print(f"  K7 {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {n_bytes:.3e} bytes, {n_flops:.3e} "
              f"flop over {pairs:.3e} valid pairs; products at 495/3 TFLOP/s); "
              f"{launches} launches a PT-v2m2 S3DIS forward; {regs} registers, no spill")
    return {"max_abs_err": worst, "ms": rows[0][1], "plain_ms": rows[0][2],
            "bound_ms": rows[0][3], "bound_by": rows[0][4],
            "shape": "patch embedding, B=2 x N=65536, C=48, G=6, S=16, pe_bias; "
                     "max_abs_err is relative to max |plain|", "rows": rows}


# ---------------------------------------------------------------------------
# phases 4-8: the slices end to end


def reset_launches():
    from pointcloudpdf_tpu_torch.ops import geometry, gva, kpconv, sampling, st_attention
    from pointcloudpdf_tpu_torch.ops import vector_attention as va

    geometry.KNN_LAUNCHES = sampling.FPS_LAUNCHES = 0
    geometry.KNN_PRUNED_LAUNCHES = geometry.KNN_BRUTE_LAUNCHES = 0
    va.ATTENTION_LAUNCHES = va.ATTENTION_TRAIN_LAUNCHES = 0
    va.ATTENTION_BWD_LAUNCHES = 0
    st_attention.ST_ATTENTION_LAUNCHES = kpconv.KPCONV_LAUNCHES = 0
    gva.GVA_LAUNCHES = 0
    gva.GVA_LAUNCHES_BY_WIDTH.clear()


def read_launches():
    from pointcloudpdf_tpu_torch.ops import geometry, gva, kpconv, sampling, st_attention
    from pointcloudpdf_tpu_torch.ops import vector_attention as va

    return {"knn": geometry.KNN_LAUNCHES, "fps": sampling.FPS_LAUNCHES,
            "vector_attention": va.ATTENTION_LAUNCHES,
            "vector_attention_train": (va.ATTENTION_TRAIN_LAUNCHES,
                                       va.ATTENTION_BWD_LAUNCHES),
            "st_attention": st_attention.ST_ATTENTION_LAUNCHES,
            "kpconv": kpconv.KPCONV_LAUNCHES, "gva": gva.GVA_LAUNCHES,
            "gva_by_width": dict(gva.GVA_LAUNCHES_BY_WIDTH)}


def read_knn_kernels():
    """K1's launches by kernel (they sum to the ``knn`` count: one a call)."""
    from pointcloudpdf_tpu_torch.ops import geometry

    pruned, brute = geometry.KNN_PRUNED_LAUNCHES, geometry.KNN_BRUTE_LAUNCHES
    expect(pruned + brute == geometry.KNN_LAUNCHES,
           f"K1: {pruned} pruned + {brute} brute-force launches = "
           f"{geometry.KNN_LAUNCHES} calls")
    return {"knn_pruned": pruned, "knn_brute": brute}


def run_tool(tool, argv):
    """Run an entry point of tools/ in this process, as ``__main__``;
    returns what it logged (the port's root logger is made once a process,
    so only the first run would find its own ``train.log``)."""
    import logging

    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("pointcloudpdf_tpu_torch")
    logger.addHandler(handler)
    old_argv, sys.argv = sys.argv, [f"tools/{tool}", *argv]
    try:
        runpy.run_path(os.path.join(ROOT, "tools", tool), run_name="__main__")
    finally:
        sys.argv = old_argv
        logger.removeHandler(handler)
    return "\n".join(lines)


def fragment_against_plain(tester, fragment):
    """A test fragment's forward on the kernels against the plain versions,
    both on the card: logits within ``TOL_LOGITS`` x max |logit|, argmax
    agreement >= 99.9%.  Returns both outputs."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    out = tester.forward_fragment(fragment)
    with _cuda.plain_versions():
        ref = tester.forward_fragment(fragment)
    lmax = float(np.abs(ref["seg_logits"]).max())
    lerr = float(np.abs(out["seg_logits"] - ref["seg_logits"]).max())
    agree = float((out["seg_logits"].argmax(-1)
                   == ref["seg_logits"].argmax(-1)).mean())
    print(f"  fragment of {len(fragment['coord'])} points, kernels against plain versions: "
          f"logits err {lerr:.3e} (max |logit| {lmax:.3e}), argmax agreement {agree:.6f}")
    expect(lerr <= TOL_LOGITS * lmax, f"seg_logits within {TOL_LOGITS} x max |logit|")
    expect(agree >= 0.999, "argmax agreement >= 99.9%")
    return out, ref


def run_slice(work, config, name, per_forward=None, gva_by_width=None,
              fragment_check=None, room=None):
    """A serving slice end to end on ``config``: the tester over the
    synthetic room with the launch counts read, then one fragment again on
    the plain versions.  ``per_forward`` gives the launches of one forward
    where the modules fix them (the Stratified Transformer's, PT-v2's); a
    kernel it leaves out must not launch; ``gva_by_width`` gives K7's by
    width.  An open-set config
    (``OpenSegTester``) also writes and checks the scores and the AUPR
    line; a closed-set one (``SemSegTester``) has neither.
    ``fragment_check(tester, fragment, batch)`` checks more of the largest
    fragment.  ``room``: ``synthetic_room``'s options (normals, density)."""
    import torch

    from pointcloudpdf_tpu_torch.models import build_model
    from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2
    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.recognizers import build_recognizer
    from pointcloudpdf_tpu_torch.utils.config import Config

    data_root = os.path.join(work, f"s3dis_{name}")
    os.makedirs(os.path.join(data_root, "Area_5"))
    n_raw = synthetic_room(np.random.RandomState(SEED),
                           os.path.join(data_root, "Area_5", "office_1.npz"),
                           **(room or {}))
    print(f"  synthetic room: {n_raw} raw points")

    cfg = Config.fromfile(config)
    tester_type = cfg.test.type
    open_set = tester_type == "OpenSegTester"
    torch.manual_seed(SEED)
    weight = os.path.join(work, f"model_{name}.pth")
    random_jax_checkpoint(weight, build_model(dict(cfg.model)),
                          build_recognizer(cfg.recognizer).model if open_set else None)
    save_path = os.path.join(work, f"exp_{name}")
    argv = ["tools/test_torch.py", "--config-file", config, "--device", DEVICE,
            "--options", f"data_root={data_root}", f"weight={weight}",
            f"save_path={save_path}",
            f"data.test.data_root={data_root}"]

    ptv2.capacity_dropped_points(reset=True)
    reset_launches()
    t0 = time.perf_counter()
    log = run_tool("test_torch.py", argv[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    knn_kernels = read_knn_kernels()
    by_width = launches.pop("gva_by_width")
    forwards = log.count(", Batch: ")
    print(f"  tools/test_torch.py ({tester_type}): {wall:.3f} s, {forwards} forwards; "
          f"launches {launches}")
    expect(launches.pop("vector_attention_train") == (0, 0),
           "serving launched no training kernel")
    dropped = ptv2.capacity_dropped_points(reset=True)
    expect(dropped == 0, f"{dropped} points dropped by a pooling capacity")

    expect("Val result: mIoU/mAcc/allAcc" in log, "mIoU line written")
    pred = np.load(glob.glob(os.path.join(save_path, "result", "*_pred.npy"))[0])
    expect(pred.shape == (n_raw,) and pred.min() >= 0 and pred.max() < 13,
           f"pred covers all {n_raw} points, in [0, 13)")
    if open_set:
        expect("Val result: aupr/auroc" in log, "AUPR/AUROC line written")
        score = np.load(glob.glob(os.path.join(save_path, "result", "*_score.npy"))[0])
        expect(score.shape == (n_raw,) and bool(np.isfinite(score).all()),
               f"score covers all {n_raw} points and is finite")
    if per_forward is None:
        expect(launches.pop("st_attention") == 0 and launches.pop("kpconv") == 0
               and launches.pop("gva") == 0,
               "the PT-v1 path launched no Stratified Transformer or PT-v2 kernel")
        for key, n in launches.items():
            expect(n > 0, f"{key} kernel launched {n} times on the main path")
    else:
        expect(forwards > 0, f"{forwards} forwards")
        for key, n in launches.items():
            want = per_forward.get(key, 0) * forwards
            expect(n == want, f"{key} kernel launched {n} times = "
                              f"{per_forward.get(key, 0)} a forward x {forwards} forwards")
        want = {c: n * forwards for c, n in (gva_by_width or {}).items()}
        expect(by_width == want, f"K7 launched {by_width} times by width = "
                                 f"{gva_by_width or {}} a forward x {forwards} forwards")

    # one fragment again, kernels against plain versions
    from pointcloudpdf_tpu_torch.engines.test import TESTERS

    cfg.merge_from_dict({"data_root": data_root, "weight": weight,
                         "save_path": os.path.join(work, f"exp_check_{name}"),
                         "data.test.data_root": data_root, "device": DEVICE})
    tester = TESTERS.build(dict(type=tester_type, cfg=cfg))
    scene = tester.test_dataset[0]
    sizes = [len(f["coord"]) for f in scene["fragment_list"]]
    print(f"  fragments: {len(sizes)}, points min {min(sizes)} max {max(sizes)}")
    expect(max(sizes) >= MIN_FRAGMENT, f"a fragment holds >= {MIN_FRAGMENT} points")
    fragment = scene["fragment_list"][int(np.argmax(sizes))]
    out, ref = fragment_against_plain(tester, fragment)
    if open_set:
        serr = float(np.abs(out["score"] - ref["score"]).max())
        expect(serr <= TOL_SCORE, f"score within {TOL_SCORE}: {serr:.3e}")

    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn

    batch = tester.device_batch(padded_collate_fn([fragment]))

    def forward():
        with torch.inference_mode():
            tester.forward(batch)

    ms = cuda_ms(forward, 3)
    with _cuda.plain_versions():
        plain_ms = cuda_ms(forward, 1)
    print(f"  per fragment ({max(sizes)} points, bucket "
          f"{batch['coord'].shape[1]}): kernels {ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"tester wall {wall / (len(sizes) or 1):.3f} s per fragment "
          f"({len(sizes)} fragments)")
    if fragment_check is not None:
        fragment_check(tester, fragment, batch)
    launches.update(knn_kernels)
    return launches


# launches of one Stratified Transformer forward (ST-v1m1 + ST recognizer, four
# layers): K5 once a block (2 + 6 + 2), K6 once a stem block; K1 for the
# stem's ball query (one table for both blocks), three TransitionDowns, two
# key-set kNNs a layer and one interpolation in each of the backbone's and
# the recognizer's three upsamples; K2 for three TransitionDowns and three
# sparse-key subsets
ST_PER_FORWARD = {"st_attention": 10, "kpconv": 2, "knn": 1 + 3 + 6 + 3 + 3,
                  "fps": 3 + 3}
# launches of one PT-v2m2 forward (S3DIS config: patch embedding 2 blocks,
# encoder 2 + 6 + 2, decoder 1 + 1 + 1): K7 once a block; K1 once a level
# (the patch level and three pooled ones; a level's table serves its encoder
# and decoder blocks)
PTV2_PER_FORWARD = {"gva": 2 + (2 + 6 + 2) + (1 + 1 + 1), "knn": 4}
# ... K7's by width: patch embedding 2 + decoder 1 at 48, stage 1 2 + decoder 1
# at 96, stage 2 6 + decoder 1 at 192, stage 3 2 at 384
PTV2_K7_BY_WIDTH = {48: 2 + 1, 96: 2 + 1, 192: 6 + 1, 384: 2}


def make_train_rooms(work, name="s3dis_train", **room):
    """Synthetic rooms over the five train areas and one val room (Area_5)
    in the S3DIS layout, under ``work/name`` (``room``: ``synthetic_room``'s
    options); returns (data_root, val room's raw points)."""
    data_root = os.path.join(work, name)
    for area in (*TRAIN_AREAS, "Area_5"):
        os.makedirs(os.path.join(data_root, area))
    rng = np.random.RandomState(SEED + 1)
    for i in range(TRAIN_ROOMS):
        synthetic_room(rng, os.path.join(
            data_root, TRAIN_AREAS[i % len(TRAIN_AREAS)], f"office_{i}.npz"), **room)
    n_val = synthetic_room(rng, os.path.join(data_root, "Area_5", "office_1.npz"), **room)
    print(f"  {TRAIN_ROOMS} train rooms over {len(TRAIN_AREAS)} areas, 1 val room "
          f"of {n_val} raw points")
    return data_root, n_val


def train_with_fallback(work, config, name, data_root, epochs, options,
                        subsample=True, sizes=(16, 8, 4, 2), areas=None, iterations=2,
                        samples=None):
    """``tools/train_torch.py`` on ``config`` at the largest batch size of
    ``sizes`` (the first the shipped one) that fits the card's memory, with
    the launch counts and the pooling capacity's drop count set to 0 just
    before the run that fits; with ``subsample`` (an open-set trainer)
    ``iterations`` an epoch at any batch size, with ``areas`` (a function of
    the batch size giving the train split under ``data_root``) as many as
    that split's rooms fill, with ``samples`` (the train split's sample
    count; no split option) as many as they fill.  Returns (log, batch
    size, iterations an epoch, wall s, launches, peak GiB, save_path)."""
    import torch

    from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2

    for batch_size in sizes:
        split = TRAIN_AREAS if areas is None else areas(batch_size)
        rooms = samples if samples is not None else sum(
            len(glob.glob(os.path.join(data_root, a, "*.npz"))) for a in split)
        iters = iterations if subsample else rooms // batch_size
        save_path = os.path.join(work, f"exp_{name}_b{batch_size}")
        argv = ["--config-file", config, "--device", DEVICE, "--options",
                f"data_root={data_root}", f"save_path={save_path}",
                f"data.train.data_root={data_root}",
                f"data.val.data_root={data_root}", "num_worker=4",
                f"batch_size={batch_size}", f"epoch={epochs}",
                f"eval_epoch={epochs}", *options]
        if subsample:
            argv.append(f"train_subsampling_ratio={iters * batch_size / TRAIN_ROOMS}")
        if areas is not None:
            argv.append(f"data.train.split={','.join(split)},")
        reset_launches()
        ptv2.capacity_dropped_points(reset=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            log = run_tool("train_torch.py", argv)
        except torch.cuda.OutOfMemoryError:
            print(f"  batch size {batch_size} does not fit the card's memory (tried for "
                  f"{time.perf_counter() - t0:.1f} s)")
        else:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            break
        # the failed run's tensors are free once its traceback is gone
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise SmokeFailure("no batch size fits the card's memory")
    launches = read_launches()
    launches.update(read_knn_kernels())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  tools/train_torch.py: batch size {batch_size} (tried: {list(sizes)}), "
          f"{epochs} epochs x {iters} iterations, {wall:.1f} s, peak device "
          f"memory {peak:.2f} GiB; launches {launches}")
    return log, batch_size, iters, wall, launches, peak, save_path


def run_training_slice(work):
    """``tools/train_torch.py`` on the shipped config at full width, then
    ``tools/test_torch.py`` on the checkpoint it saved."""
    import re

    data_root, n_val = make_train_rooms(work)
    epochs, start_epoch = 3, 2
    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, CONFIG, "train", data_root, epochs,
        [f"data.test.data_root={data_root}", f"recognizer.start_epoch={start_epoch}"])

    steps = epochs * iters
    step_log = "\n".join(line for line in log.splitlines() if "Train: [" in line)
    expect(step_log.count("Train: [") == steps, f"{steps} train steps logged")
    losses = [float(v) for v in re.findall(r" loss: ([-+.\w]+) ", step_log)]
    expect(len(losses) == steps and all(np.isfinite(losses)),
           f"every loss finite: {losses}")
    rec = [float(v) for v in re.findall(r"loss_rec: ([-+.\w]+) ", step_log)]
    expect(len(rec) == steps and all(np.isfinite(rec)),
           f"loss_rec reported at every step and finite: {rec}")
    # past start_epoch a batch's step runs one iteration late (the last at
    # the end of the epoch), so iters - 1 of its lines carry the share of
    # points that the pseudo-labelling flagged
    flagged = [float(v) for v in re.findall(r"pseudo_flagged: ([-+.\w]+) ", step_log)]
    expect(len(flagged) == iters - 1 and all(np.isfinite(flagged)),
           f"pseudo_flagged reported past start_epoch: {flagged}")
    batch_times = [float(v) for v in re.findall(r"Batch ([.\d]+) \(", step_log)]
    print(f"  host clock per iteration (s): {batch_times}")
    expect(len(re.findall(r"Val result: mIoU/mAcc/allAcc", log)) == epochs
           and len(re.findall(r"Val result: aupr/auroc", log)) == epochs,
           "evaluator reported mIoU and AUPR/AUROC after every epoch")
    for line in re.findall(r"Val result: [^\n]*", log)[-2:]:
        print("  " + line)
    # 18 attention layers in Seg50: per train step 18 forward + 18 backward
    # launches of K4; K3 serves the score passes and the evaluator
    fwd, bwd = launches["vector_attention_train"]
    expect(fwd == bwd == 18 * steps,
           f"K4: {fwd} forward + {bwd} backward launches = 18 x {steps} steps")
    k3_passes = iters + epochs  # score passes past start_epoch + val batches
    expect(launches["vector_attention"] == 18 * k3_passes,
           f"K3: {launches['vector_attention']} launches = 18 x ({iters} score "
           f"passes + {epochs} evaluator forwards)")
    expect(launches["knn"] > 0 and launches["fps"] > 0,
           f"K1 {launches['knn']} and K2 {launches['fps']} launches")

    weight = os.path.join(save_path, "model", "model_last.pth")
    expect(os.path.isfile(weight), "checkpoint model_last.pth saved")
    test_save = os.path.join(work, "exp_train_test")
    log = run_tool("test_torch.py", [
        "--config-file", CONFIG, "--device", DEVICE, "--options",
        f"data_root={data_root}", f"weight={weight}", f"save_path={test_save}",
        f"data.test.data_root={data_root}"])
    expect("Val result: mIoU/mAcc/allAcc" in log and "Val result: aupr/auroc" in log,
           "tools/test_torch.py loaded the trainer's checkpoint and tested it")
    pred = np.load(glob.glob(os.path.join(test_save, "result", "*_pred.npy"))[0])
    expect(pred.shape == (n_val,) and pred.min() >= 0 and pred.max() < 13,
           f"pred covers all {n_val} points of the val room")
    return launches, data_root, batch_size, peak, weight, n_val


def compare_train_steps(work, data_root):
    """Three train steps from one seeded state on one fixed batch, on the
    kernels and on the plain versions; then one step under autocast."""
    import copy

    import torch

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.models.point_transformer import modules
    from pointcloudpdf_tpu_torch.ops import _cuda

    cfg = default_config_parser(CONFIG, {
        "data_root": data_root, "data.train.data_root": data_root,
        "data.val.data_root": data_root, "save_path": os.path.join(work, "exp_steps"),
        "device": DEVICE, "batch_size": 2, "num_worker": 0, "evaluate": False,
        "enable_amp": False, "hooks": [], "seed": SEED,
        # at the shipped rate of 0.5 a step from random weights multiplies
        # any difference some 50-fold (measured here: the losses of the two
        # runs differed by 0, 1.1e-4 and 5.7e-3 of their value; at 0.01 by
        # 0, 3.5e-5 and 8.2e-4), so three steps at that rate would compare
        # two trajectories, not two sets of kernels
        "optimizer.lr": STEPS_LR})
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=cfg))
    input_dict = next(iter(trainer.train_loader))
    batch = trainer.device_batch(input_dict)
    print(f"  fixed batch: {tuple(batch['coord'].shape)}, valid points "
          f"{input_dict['count'].tolist()}, lr {STEPS_LR}")
    rec_w = trainer.recognizer.alpha
    start = {n: copy.deepcopy(m.state_dict()) for n, m in trainer.modules().items()}

    def three_steps(calls):
        """The losses of three steps, the gradient the optimizer was handed
        at the first, and (appended to ``calls``) the inputs and the output
        gradient of every attention layer of that first step."""
        for name, module in trainer.modules().items():
            module.load_state_dict(start[name])
        trainer.optimizer = trainer.build_optimizer()
        trainer._host_step = 0
        losses, grads = [], {}
        optimizer_step = trainer.optimizer.step
        attention = modules.vector_attention_train

        def recording_step():
            if not grads:
                grads.update({n: p.grad.detach().clone()
                              for n, p in trainer.named_parameters()})
            return optimizer_step()

        def recording_attention(*args, **kwargs):
            out = attention(*args, **kwargs)
            call = {"args": [a.detach() for a in args]}
            out.register_hook(lambda g: call.__setitem__("dout", g.detach()))
            calls.append(call)
            return out

        trainer.optimizer.step = recording_step
        for i in range(3):
            modules.vector_attention_train = (recording_attention if i == 0
                                              else attention)
            try:
                trainer._dispatch_train(batch, rec_w)
            finally:
                modules.vector_attention_train = attention
            losses.append(float(trainer.comm_info["model_output_dict"]["loss"]))
        return losses, grads

    calls = []
    losses, grads = three_steps(calls)
    with _cuda.plain_versions():
        plosses, pgrads = three_steps([])
    print(f"  losses on kernels {losses}, on plain versions {plosses}")
    for a, b in zip(losses, plosses):
        expect(abs(a - b) <= TOL_STEPS * abs(b),
               f"loss {a:.6f} within {TOL_STEPS} of plain {b:.6f}")

    # The first step's gradient, every parameter.  Its tolerance is the f32
    # noise of this network's backward pass (its batch-statistic BatchNorms
    # one after another, from random weights), measured on the CPU against
    # a float64 gradient in tests/test_torch_train.py; a wrong or missing
    # term is an error of order 1.  A bias ahead of a batch-statistic BatchNorm or the
    # softmax has an exact gradient of 0, so a bias is held to the larger of
    # its own and its weight's scale.
    worst, diff2, norm2 = (0.0, None), 0.0, 0.0
    for key, r in pgrads.items():
        scale = float(r.abs().max())
        weight = key[:-len("bias")] + "weight"
        if key.endswith(".bias") and weight in pgrads and r.shape != pgrads[weight].shape:
            scale = max(scale, float(pgrads[weight].abs().max()))
        worst = max(worst, (float((grads[key] - r).abs().max()) / max(scale, 1e-30), key))
        diff2 += float(((grads[key] - r).double() ** 2).sum())
        norm2 += float((r.double() ** 2).sum())
    whole = (diff2 / norm2) ** 0.5
    expect(len(grads) == len(pgrads) and worst[0] <= TOL_GRAD,
           f"first step's gradient, {len(pgrads)} tensors: worst {worst[0]:.3e} of its "
           f"max |grad| at {worst[1]} <= {TOL_GRAD}")
    expect(whole <= TOL_GRAD_WHOLE,
           f"first step's gradient as a whole: {whole:.3e} of its length (L2) "
           f"<= {TOL_GRAD_WHOLE}")

    # What that noise cannot blur: each attention layer of the step on its
    # own, on the inputs and the output gradient it had in the step.
    expect(len(calls) == 18 and all("dout" in c for c in calls),
           "18 attention layers of the first step recorded with their output gradients")
    for i, call in enumerate(calls):
        feats = [t.clone().requires_grad_(True) for t in call["args"][:3]]
        coord, idx, nmask = call["args"][3:6]
        params = [t.clone().requires_grad_(True) for t in call["args"][6:20]]
        compare_attention_train(
            f"layer {i + 1}/18 of the step, N={feats[0].shape[1]} "
            f"C={feats[0].shape[2]} K={idx.shape[2]}",
            feats, coord, idx, nmask, params, call["dout"])

    trainer.cfg.enable_amp = True
    trainer._dispatch_train(batch, rec_w)
    amp_loss = float(trainer.comm_info["model_output_dict"]["loss"])
    expect(np.isfinite(amp_loss), f"one step under bfloat16 autocast: loss {amp_loss:.4f}")


def train_log_losses(log, steps, keys=("loss",)):
    """The per-step values of ``keys`` in a training log, each asserted
    finite at every one of ``steps`` steps."""
    import re

    step_log = "\n".join(line for line in log.splitlines() if "Train: [" in line)
    expect(step_log.count("Train: [") == steps, f"{steps} train steps logged")
    out = {}
    for key in keys:
        values = [float(v) for v in re.findall(rf"\b{key}: ([-+.\w]+) ", step_log)]
        expect(len(values) == steps and all(np.isfinite(values)),
               f"{key} finite at every step: {values}")
        out[key] = values
    return out


def run_st_training_slice(work, data_root, n_val):
    """``tools/train_torch.py`` on the shipped S3DIS ST config at full width
    (ST-v1m1 + ST recognizer, AdamW with the blocks' group, the warm-up
    schedule, drop path 0.3 from the trainer's generator), the last epoch
    past ``recognizer.start_epoch``; then ``tools/test_torch.py`` on the
    checkpoint it saved.  K5 and K6 have no backward: the training forwards
    take their plain versions, so they launch in the score passes and the
    evaluator's forwards alone."""
    import re

    epochs, start_epoch = 2, 1
    # an epoch of one step (the ST step is the script's slowest, PERF.md §5)
    # and the shipped 16 and 8 not tried (they do not fit one H100 80GB): the
    # script's time limit
    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, ST_CONFIG, "st_train", data_root, epochs,
        [f"data.test.data_root={data_root}", f"recognizer.start_epoch={start_epoch}"],
        sizes=(4, 2), iterations=1)
    steps = epochs * iters
    losses = train_log_losses(log, steps, ("loss", "loss_rec"))
    print(f"  losses {losses['loss']}, loss_rec {losses['loss_rec']}")
    expect(len(re.findall(r"Val result: mIoU/mAcc/allAcc", log)) == epochs
           and len(re.findall(r"Val result: aupr/auroc", log)) == epochs,
           "evaluator reported mIoU and AUPR/AUROC after every epoch")
    # score passes past start_epoch (one an iteration) + one val room an epoch
    forwards = iters * (epochs - start_epoch) + epochs
    for key in ("st_attention", "kpconv"):
        want = ST_PER_FORWARD[key] * forwards
        expect(launches[key] == want,
               f"{key}: {launches[key]} launches = {ST_PER_FORWARD[key]} x "
               f"{forwards} eval forwards ({iters} score passes + {epochs} "
               f"evaluator forwards), none in the {steps} training forwards")
    expect(launches["vector_attention"] == 0 and launches["gva"] == 0
           and launches["vector_attention_train"] == (0, 0),
           "the ST path launched no PT-v1 or PT-v2 kernel")
    expect(launches["knn"] > 0 and launches["fps"] > 0,
           f"K1 {launches['knn']} and K2 {launches['fps']} launches")

    weight = os.path.join(save_path, "model", "model_last.pth")
    expect(os.path.isfile(weight), "checkpoint model_last.pth saved")
    test_save = os.path.join(work, "exp_st_train_test")
    log = run_tool("test_torch.py", [
        "--config-file", ST_CONFIG, "--device", DEVICE, "--options",
        f"data_root={data_root}", f"weight={weight}", f"save_path={test_save}",
        f"data.test.data_root={data_root}"])
    expect("Val result: mIoU/mAcc/allAcc" in log and "Val result: aupr/auroc" in log,
           "tools/test_torch.py loaded the ST trainer's checkpoint and tested it")
    pred = np.load(glob.glob(os.path.join(test_save, "result", "*_pred.npy"))[0])
    expect(pred.shape == (n_val,) and pred.min() >= 0 and pred.max() < 13,
           f"pred covers all {n_val} points of the val room")
    return launches, batch_size, peak


def incr_test_config(work):
    """The shipped incremental config with a test set: the shipped open-set
    config's ``data.test`` (fragment voting over the Area_5 rooms), which
    the incremental configs leave out."""
    from pointcloudpdf_tpu_torch.utils.config import Config

    test = Config.fromfile(CONFIG).to_dict()["data"]["test"]
    test.pop("unknown_label", None)
    path = os.path.join(work, "incrseg-pt-v1-test.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{INCR_CONFIG!r}]\ndata = dict(test={test!r})\n")
    return path


def run_incr_slice(work, data_root, n_val, base_weight):
    """``tools/train_torch.py`` on the shipped incremental config (a frozen
    Seg50 teacher from phase 5's checkpoint distilled into a Seg50 student
    with two more classes, autocast as shipped), then ``tools/test_torch.py``
    (``IncrSegTester``) on the student it saved; then one incremental step
    twice from one state, on the kernels and on the plain versions, and the
    teacher's logits under bfloat16 autocast (K3) against its f32 plain
    version."""
    import copy
    import re

    import torch

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.ops import vector_attention as va

    epochs = 2
    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, INCR_CONFIG, "incr_train", data_root, epochs,
        [f"base_ckpt={base_weight}"], subsample=False)
    steps = epochs * iters
    expect("Loading base weights into the student (trim_base_weight_head)" in log,
           "the base checkpoint started the teacher and the student")
    losses = train_log_losses(log, steps)["loss"]
    print(f"  distillation losses {losses}")
    for tag in ("known", "incr", "remap"):
        n = len(re.findall(rf"Val result: mIoU/mAcc/Acc {tag} ", log))
        expect(n == epochs, f"{tag} mIoU/mAcc/Acc logged after every epoch ({n})")
    for line in re.findall(r"Val result: [^\n]*", log)[-3:]:
        print("  " + line)
    # 18 attention layers a Seg50: the student's train forward and backward
    # on K4; the teacher's forward in each step and the student's val
    # forwards on K3
    fwd, bwd = launches["vector_attention_train"]
    expect(fwd == bwd == 18 * steps,
           f"K4: {fwd} forward + {bwd} backward launches = 18 x {steps} steps")
    expect(launches["vector_attention"] == 18 * (steps + epochs),
           f"K3: {launches['vector_attention']} launches = 18 x ({steps} teacher "
           f"forwards + {epochs} val forwards)")
    expect(launches["st_attention"] == launches["kpconv"] == launches["gva"] == 0,
           "the incremental path launched no ST or PT-v2 kernel")
    expect(launches["knn"] > 0 and launches["fps"] > 0,
           f"K1 {launches['knn']} and K2 {launches['fps']} launches")

    weight = os.path.join(save_path, "model", "model_last.pth")
    expect(os.path.isfile(weight), "student checkpoint model_last.pth saved")
    test_save = os.path.join(work, "exp_incr_test")
    reset_launches()
    log = run_tool("test_torch.py", [
        "--config-file", incr_test_config(work), "--device", DEVICE, "--options",
        f"weight={weight}", f"save_path={test_save}",
        f"data.test.data_root={data_root}"])
    forwards = log.count(", Batch: ")
    tested = read_launches()
    for tag in ("known", "incr", "remap"):
        expect(f"Val result: mIoU/mAcc/Acc {tag} " in log,
               f"IncrSegTester logged the {tag} triple")
    for line in re.findall(r"Val result: [^\n]*", log):
        print("  " + line)
    expect(forwards > 0 and tested["vector_attention"] == 18 * forwards,
           f"IncrSegTester: K3 {tested['vector_attention']} launches = 18 x "
           f"{forwards} fragment forwards")
    pred = np.load(glob.glob(os.path.join(test_save, "result", "*_pred.npy"))[0])
    expect(pred.shape == (n_val,) and pred.min() >= 0 and pred.max() < 15,
           f"pred covers all {n_val} points of the val room, in [0, 15)")

    # one incremental step, twice from one state: kernels, plain versions
    cfg = default_config_parser(INCR_CONFIG, {
        "data_root": data_root, "data.train.data_root": data_root,
        "data.val.data_root": data_root, "save_path": os.path.join(work, "exp_incr_steps"),
        "device": DEVICE, "batch_size": 2, "num_worker": 0, "evaluate": False,
        "enable_amp": False, "hooks": [dict(type="IncrSegCheckpointLoader")],
        "seed": SEED, "base_ckpt": base_weight, "optimizer.lr": STEPS_LR})
    trainer = TRAINERS.build(dict(type="IncrSegTrainer", cfg=cfg))
    trainer.hooks[0].before_train()
    batch = trainer.device_batch(next(iter(trainer.train_loader)))
    start = copy.deepcopy(trainer.student.state_dict())

    def two_steps():
        trainer.student.load_state_dict(start)
        trainer.optimizer = trainer.build_optimizer()
        trainer._host_step = 0
        out = []
        for _ in range(2):
            trainer._dispatch_train(batch)
            out.append(float(trainer.comm_info["model_output_dict"]["loss"]))
        return out

    reset_launches()
    got = two_steps()
    on_kernels = read_launches()
    with _cuda.plain_versions():
        ref = two_steps()
    on_plain = read_launches()
    print(f"  incremental steps: losses on kernels {got}, on plain versions {ref}")
    expect(on_kernels["vector_attention_train"] == (36, 36)
           and on_kernels["vector_attention"] == 36,
           f"two steps on the kernels: K4 {on_kernels['vector_attention_train']}, "
           f"K3 {on_kernels['vector_attention']} launches (18 x 2 each)")
    expect(on_plain == on_kernels, "the steps on the plain versions launched no kernel")
    for a, b in zip(got, ref):
        expect(abs(a - b) <= TOL_STEPS * abs(b),
               f"loss {a:.6f} within {TOL_STEPS} of plain {b:.6f}")

    k3 = va.ATTENTION_LAUNCHES
    with torch.autocast("cuda", dtype=torch.bfloat16):
        amp = trainer.teacher_logits(batch).float()
    expect(va.ATTENTION_LAUNCHES - k3 == 18, "the teacher under autocast ran K3 18 times")
    with _cuda.plain_versions():
        plain = trainer.teacher_logits(batch)
    valid = batch["mask"]
    lmax = float(plain[valid].abs().max())
    err = float((amp - plain)[valid].abs().max())
    agree = float((amp.argmax(-1) == plain.argmax(-1))[valid].float().mean())
    print(f"  teacher logits under bfloat16 autocast (K3) against f32 plain: err "
          f"{err:.3e} (max |logit| {lmax:.3e}), argmax agreement {agree:.4f}")
    expect(err <= TOL_AMP_LOGITS * lmax,
           f"teacher logits under autocast within {TOL_AMP_LOGITS} x max |logit|")
    return launches, batch_size, peak


# phase 11: PT-v2 training.  The shipped batch, its halves, and 2 and 1
# (3 does not fit one H100: the level capacities are shares of the padded
# length, Mix3D's empty slots included, so each of the 15 blocks keeps
# (B, N, 16, C) tensors of about the same size for the backward); the
# evaluator's and the tester's forwards launch K7 and K1 as phase 8's
# (PTV2_PER_FORWARD, PTV2_K7_BY_WIDTH), a training forward K1 alone
PTV2_TRAIN_BATCHES = (12, 6, 3, 2, 1)
CAC_CONFIG = os.path.join(ROOT, "configs", "scannet",
                          "semseg-cac-v1m1-2-ptv2-lovasz.py")
# launches of one CAC-v1m1 eval forward over its ScanNet PT-v2m2 backbone
# (patch embedding 1 block, encoder 2 + 2 + 6 + 2, decoder 1 + 1 + 1 + 1): K7
# once a block, K1 once a level (the patch level and four pooled ones)
CAC_PER_FORWARD = {"gva": 1 + 12 + 4, "knn": 5}
CAC_K7_BY_WIDTH = {48: 1 + 1, 96: 2 + 1, 192: 2 + 1, 384: 6 + 1, 512: 2}
# points a sample of CAC's step and their bucket: its config keeps every
# level at the padded length (no capacity factor), so the (B, N, 16, C)
# tensors its 17 blocks keep for the backward grow with C at every level; a
# step at 2 x 24,000 points does not fit the card's memory.  The widths are
# the config's
CAC_POINTS, CAC_BUCKET = 8000, 8192


def two_batch_splits(work, data_root, name="s3dis_two_batches"):
    """A data root ``work/name`` with one train split a batch size,
    ``Batch{b}``, of 2 b of ``data_root``'s rooms (links), and its val area:
    an epoch of two iterations at any batch size.  Returns the root."""
    root = os.path.join(work, name)
    if os.path.isdir(root):
        return root
    os.makedirs(root)
    os.symlink(os.path.join(data_root, "Area_5"), os.path.join(root, "Area_5"))
    rooms = sorted(glob.glob(os.path.join(data_root, "Area_[1-46]", "*.npz")))
    for b in PTV2_TRAIN_BATCHES:
        split = os.path.join(root, f"Batch{b}")
        os.makedirs(split)
        for i, path in enumerate(rooms[:2 * b]):
            os.symlink(path, os.path.join(split, f"office_{i}.npz"))
    return root


def run_ptv2_training_slice(work, data_root, n_val):
    """``tools/train_torch.py`` on the shipped S3DIS PT-v2m2 config at full
    width over phase 5's rooms, as shipped (AdamW, MultiStepLR, autocast,
    Mix3D at 0.8, drop path 0.3, level capacity 0.5) at the largest batch of
    12, 6, 3, 2 and 1 that fits, one epoch of two steps and the evaluator,
    with ``PreciseEvaluator`` appended to the hooks (``SemSegTester`` on
    ``model_best.pth`` in-process).  K7 has no backward: the training
    forwards take ``gva_plain``, so K7 launches in the evaluator's and the
    tester's forwards alone, K1 in every forward; no point dropped by the
    pooling capacity.  Then one val batch on the kernels and on the plain
    versions, one step's loss under autocast against f32, and one
    ``DefaultTrainer`` step and eval forward of CAC-v1m1 over the ScanNet
    PT-v2m2 at full width."""
    import re

    import torch

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2
    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.utils.checkpoint import load_checkpoint
    from pointcloudpdf_tpu_torch.utils.config import Config

    hooks = [dict(h) for h in Config.fromfile(PTV2_CONFIG).hooks]
    hooks.append({"type": "PreciseEvaluator", "test_last": False})
    epochs = 1
    split_root = two_batch_splits(work, data_root)
    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, PTV2_CONFIG, "ptv2_train", split_root, epochs,
        [f"data.test.data_root={data_root}", f"hooks={hooks!r}"], subsample=False,
        sizes=PTV2_TRAIN_BATCHES, areas=lambda b: (f"Batch{b}",))
    by_width = launches.pop("gva_by_width")
    dropped = ptv2.capacity_dropped_points(reset=True)
    steps = epochs * iters
    losses = train_log_losses(log, steps)["loss"]
    print(f"  losses {losses}")
    for line in re.findall(r"Val result: [^\n]*", log):
        print("  " + line)
    expect(dropped == 0, f"{dropped} points dropped by the pooling capacity in "
                         "the training, evaluator and tester forwards")
    expect("Start Precise Evaluation" in log
           and "model_best.pth" in log.split("Start Precise Evaluation")[-1],
           "PreciseEvaluator ran the tester on model_best.pth")
    pred = np.load(glob.glob(os.path.join(save_path, "result", "*_pred.npy"))[0])
    expect(pred.shape == (n_val,) and pred.min() >= 0 and pred.max() < 13,
           f"the tester's pred covers all {n_val} points of the val room")
    # one val room an epoch (batch_size_val 1), then the tester's fragments
    evaluated = epochs
    tested = log.split("Start Precise Evaluation")[-1].count(", Batch: ")
    eval_forwards = evaluated + tested
    expect(tested > 0, f"{tested} tester forwards")
    want = PTV2_PER_FORWARD["gva"] * eval_forwards
    expect(launches["gva"] == want,
           f"K7: {launches['gva']} launches = {PTV2_PER_FORWARD['gva']} x "
           f"({evaluated} evaluator + {tested} tester forwards), none in the "
           f"{steps} training forwards")
    want = {c: n * eval_forwards for c, n in PTV2_K7_BY_WIDTH.items()}
    expect(by_width == want, f"K7 by width {by_width} = {PTV2_K7_BY_WIDTH} a "
                             f"forward x {eval_forwards}")
    want = PTV2_PER_FORWARD["knn"] * (steps + eval_forwards)
    expect(launches["knn"] == want,
           f"K1: {launches['knn']} launches = {PTV2_PER_FORWARD['knn']} x ({steps} "
           f"training + {eval_forwards} eval forwards)")
    expect(launches["vector_attention"] == launches["st_attention"]
           == launches["kpconv"] == launches["fps"] == 0
           and launches["vector_attention_train"] == (0, 0),
           "the PT-v2 path launched no PT-v1 or ST kernel and no K2")
    gc.collect()
    torch.cuda.empty_cache()

    # one val batch, kernels against plain versions; one step's loss, f32
    # against autocast
    cfg = default_config_parser(PTV2_CONFIG, {
        "data_root": data_root, "data.train.data_root": data_root,
        "data.val.data_root": data_root, "save_path": os.path.join(work, "exp_ptv2_check"),
        "device": DEVICE, "batch_size": 2, "num_worker": 0, "hooks": [],
        "seed": SEED, "mix_prob": 0.0})
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=cfg))
    trainer.load_state_dict(load_checkpoint(
        os.path.join(save_path, "model", "model_best.pth"))["state"])
    val = trainer.device_batch(next(iter(trainer.val_loader)))
    reset_launches()
    out = trainer.eval_step(val)["seg_logits"]
    one = read_launches()
    with _cuda.plain_versions():
        ref = trainer.eval_step(val)["seg_logits"]
    expect(one["gva"] == PTV2_PER_FORWARD["gva"] and one["knn"] == PTV2_PER_FORWARD["knn"],
           f"the val forward launched K7 {one['gva']} and K1 {one['knn']} times")
    valid = val["mask"]
    lmax = float(ref[valid].abs().max())
    lerr = float((out - ref)[valid].abs().max())
    agree = float((out.argmax(-1) == ref.argmax(-1))[valid].float().mean())
    print(f"  val batch {list(val['coord'].shape)}: logits err {lerr:.3e} (max |logit| "
          f"{lmax:.3e}), argmax agreement {agree:.6f}")
    expect(lerr <= TOL_LOGITS * lmax, f"val logits within {TOL_LOGITS} x max |logit|")
    expect(agree >= 0.999, "argmax agreement >= 99.9%")

    batch = trainer.device_batch(next(iter(trainer.train_loader)))
    step_losses = {}
    for amp in (False, True):
        trainer.cfg.enable_amp = amp
        trainer._train_mode(True)
        trainer.generator.manual_seed(SEED)
        with torch.no_grad(), trainer._amp():
            loss, _ = trainer.compute_loss(trainer.forward_train(trainer.model, batch), batch)
        step_losses[amp] = float(loss)
    f32, amp = step_losses[False], step_losses[True]
    print(f"  one step's loss: f32 {f32:.6f}, bfloat16 autocast {amp:.6f}")
    expect(np.isfinite(amp) and abs(amp - f32) <= TOL_AMP_LOGITS * abs(f32),
           f"the autocast loss finite and within {TOL_AMP_LOGITS} of the f32 loss")
    del trainer, val, out, ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    cac = run_cac_step(work, data_root)
    return launches, batch_size, peak, cac


def run_cac_step(work, data_root):
    """One ``DefaultTrainer`` step and one eval forward of CAC-v1m1 over the
    ScanNet PT-v2m2 at full width, from the shipped config's model dict, on
    a batch of two synthetic rooms of ``CAC_POINTS`` points with 9 channels
    (coordinates, colours, stand-in normals): the model's own loss and its
    four parts, finite; K7 in the eval forward alone."""
    import torch

    from pointcloudpdf_tpu_torch.datasets import DATASETS
    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    class Rooms:
        """Stands in for the ScanNet set the config names: the step is fed
        its batch."""

        def __init__(self, **kwargs):
            pass

        def __len__(self):
            return 4

    DATASETS.register_module("SmokeRooms", module=Rooms, force=True)
    cfg = default_config_parser(CAC_CONFIG, {
        "device": DEVICE, "batch_size": 2, "num_worker": 0, "evaluate": False,
        "hooks": [], "seed": SEED, "save_path": os.path.join(work, "exp_cac"),
        "data.train": {"type": "SmokeRooms"}})
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=cfg))
    rng = np.random.RandomState(SEED + 2)
    rooms = sorted(glob.glob(os.path.join(data_root, TRAIN_AREAS[0], "*.npz")))[:2]
    n_pad, coords, feats, segs, counts = CAC_BUCKET, [], [], [], []
    for path in rooms:
        room = np.load(path)
        keep = rng.permutation(len(room["coord"]))[:CAC_POINTS]
        coord = room["coord"][keep]
        normal = rng.normal(size=coord.shape)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        feat = np.concatenate([coord - coord.mean(0), room["color"][keep] / 255.0,
                               normal], 1).astype(np.float32)
        seg = np.minimum(room["semantic_gt"][keep], 19)
        pad = n_pad - len(coord)
        coords.append(np.pad(coord - coord.min(0), ((0, pad), (0, 0))))
        feats.append(np.pad(feat, ((0, pad), (0, 0))))
        segs.append(np.pad(seg, (0, pad), constant_values=-1))
        counts.append(len(coord))
    batch = trainer.device_batch(dict(
        coord=np.stack(coords).astype(np.float32), feat=np.stack(feats),
        segment=np.stack(segs).astype(np.int64), count=np.array(counts, np.int32)))
    reset_launches()
    trainer._dispatch_train(batch)
    out = {k: float(v) for k, v in trainer.comm_info["model_output_dict"].items()}
    in_step = read_launches()
    print(f"  CAC-v1m1 step, batch {list(batch['coord'].shape)}: {out}")
    expect(set(out) == {"loss", "seg_loss", "pre_loss", "pre_self_loss", "kl_loss"}
           and all(np.isfinite(v) for v in out.values()),
           "CAC: the model's loss and its four parts, finite")
    expect(in_step["gva"] == 0 and in_step["knn"] == CAC_PER_FORWARD["knn"],
           f"CAC step: K7 {in_step['gva']}, K1 {in_step['knn']} launches")
    reset_launches()
    logits = trainer.eval_step(batch)["seg_logits"]
    in_eval = read_launches()
    expect(bool(torch.isfinite(logits).all()) and logits.shape[-1] == 20,
           "CAC eval logits finite, 20 classes")
    expect(in_eval["gva"] == CAC_PER_FORWARD["gva"]
           and in_eval["gva_by_width"] == CAC_K7_BY_WIDTH
           and in_eval["knn"] == CAC_PER_FORWARD["knn"],
           f"CAC eval forward: K7 {in_eval['gva_by_width']}, K1 {in_eval['knn']} "
           f"launches = {CAC_K7_BY_WIDTH}, {CAC_PER_FORWARD['knn']}")
    return {key: in_step.get(key, 0) + in_eval.get(key, 0)
            for key in ("knn", "gva")}


# ---------------------------------------------------------------------------
# phase 12: the data-parallel engine (two gloo ranks on the card; NCCL at
# world 1; the tester on two ranks)

DDP_SIZES = (16, 8, 4)  # global batch of phase 12(a): 2 x 8 first, as phase 5's 16
# running statistics after the first step, world 2 against world 1, of max(1, |stat|):
# the attention stats pass sums B N K = 21M rows in f32 in another order (1.77e-4
# measured); in float64 the two layouts agree to 1e-10, running statistics and
# the next batch's pseudo-labels alike
# (tests/test_torch_ddp.py::test_float64_pseudo_labels_after_an_update_match_one_process),
# so that order is the whole difference
TOL_DDP_STATS = 1e-3
# the score sheets from equal weights, world 2 against world 1, of max |sheet|: the
# same f32 sums, but cuBLAS picks its GEMM by the row count and rounds apart
# (4.8e-7-6.6e-7 of max |sheet| measured), which flips a few points in the host graph stage at
# some batches; the graph stage on equal sheets is held bit for bit
TOL_DDP_SHEETS = 1e-5
# the first step's gradient in float64, two ranks against one process, of a
# tensor's max |grad| (tests/test_torch_ddp.py holds 1e-9 on the CPU)
TOL_FLOAT64_RANKS = 1e-10


def gradient_errors(grads, ref):
    """A whole-network gradient against a reference (dicts of numpy arrays
    by parameter name, over the reference's keys): each tensor's error of
    its max |grad| (a bias at the larger of its own and its weight's scale:
    a bias ahead of a batch-statistic BatchNorm or the softmax has an exact
    gradient of 0), and the whole gradient's error of its length (L2)."""
    errors, diff2, norm2 = {}, 0.0, 0.0
    for key, r in ref.items():
        r = r.astype(np.float64)
        g = grads[key].astype(np.float64)
        scale = float(np.abs(r).max())
        weight = key[:-len("bias")] + "weight"
        if key.endswith(".bias") and weight in ref and r.shape != ref[weight].shape:
            scale = max(scale, float(np.abs(ref[weight]).max()))
        errors[key] = float(np.abs(g - r).max()) / max(scale, 1e-30)
        diff2 += float(((g - r) ** 2).sum())
        norm2 += float((r ** 2).sum())
    return errors, (diff2 / norm2) ** 0.5


def gradient_gap(grads, ref):
    """``gradient_errors``' worst tensor (error, name) and whole error."""
    errors, whole = gradient_errors(grads, ref)
    worst = max(errors, key=errors.get)
    return (errors[worst], worst), whole


@contextlib.contextmanager
def float64_plain():
    """A float64 pass of the PT-v1 open-set model on the card: the kernels'
    plain versions (K1-K4 are f32 kernels), a training attention layer on
    its plain differentiable formulation (``_unfused``, the CPU's; the
    fused op's batch-statistic pass is f32), the port's f32 casts
    (``.float()``) letting a float64 tensor through, and every attention
    layer and down transition recomputing its forward in the backward
    (``torch.utils.checkpoint``) instead of keeping its (B, N, K, C)
    tensors, which at phase 12's batch would not fit the card in float64.
    The discrete choices stay the f32 run's: FPS picks and kNN tables are
    taken on the f32 coordinates (the plain versions equal K1 and K2 bit
    for bit there), the kNN distances then computed in float64; in float64
    a near-tie would pick other points and another network."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from pointcloudpdf_tpu_torch.models.point_transformer import modules
    from pointcloudpdf_tpu_torch.models.point_transformer import point_transformer_seg as seg
    from pointcloudpdf_tpu_torch.ops import _cuda, geometry

    to_float = torch.Tensor.float
    knn, fps = geometry.knn, modules.blocked_farthest_point_sampling

    def f32_knn(query, ref, k, ref_mask=None):
        idx, dist2 = knn(query.to(torch.float32), ref.to(torch.float32), k, ref_mask=ref_mask)
        if query.dtype != torch.float64:
            return idx, dist2
        diff = geometry.gather_rows(ref, idx.clamp(min=0)) - query[:, :, None, :]
        return idx, torch.where(torch.isfinite(dist2), (diff * diff).sum(-1),
                                torch.full_like(dist2, float("inf"), dtype=torch.float64))

    def f32_fps(coord, *args, **kwargs):
        return fps(coord.to(torch.float32), *args, **kwargs)

    layer = modules.PointTransformerLayer
    fused_train = layer._fused_train
    layer._fused_train = layer._unfused
    geometry.knn = modules.knn = seg.knn = f32_knn
    modules.blocked_farthest_point_sampling = f32_fps
    forwards = {cls: cls.forward for cls in (layer, modules.TransitionDown)}
    torch.Tensor.float = lambda t, *args, **kwargs: (
        t if t.dtype == torch.float64 else to_float(t, *args, **kwargs))
    def recomputed(forward):
        def wrapped(self, *args):
            return checkpoint(forward, self, *args, use_reentrant=False)
        return wrapped

    for cls, forward in forwards.items():
        cls.forward = recomputed(forward)
    try:
        with _cuda.plain_versions():
            yield
    finally:
        torch.Tensor.float = to_float
        layer._fused_train = fused_train
        geometry.knn = modules.knn = seg.knn = knn
        modules.blocked_farthest_point_sampling = fps
        for cls, forward in forwards.items():
            cls.forward = forward


def float64_first_gradient(work, cfg, input_dict):
    """The gradient of phase 12(a)'s first step (epoch 0: the segmentation
    loss alone) from the saved start, in float64 on the plain versions, on
    this process's share of the global batch ``input_dict``, summed over
    the ranks where there are several: {name: float64 array}."""
    import torch

    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=cfg))
    start = torch.load(os.path.join(work, "ddp_start.pt"))
    for name, module in trainer.modules().items():
        module.load_state_dict(start[name])
    model = trainer.model.double().train()
    batch = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
             for k, v in trainer.device_batch(input_dict).items()}
    with float64_plain():
        model.loss(model(batch)["seg_logits"], batch["segment"]).backward()
    trainer.sum_gradients()
    grads = {f"model.{n}": p.grad.cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    del trainer, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return grads


def ddp_float64_rank(work, cfg):
    """``launch``'s ``main_func`` for phase 12(a)'s float64 check: this
    rank's shard of the first global batch through ``float64_first_gradient``;
    pickled to ``work/ddp64_rank<r>.pkl``."""
    import pickle

    from pointcloudpdf_tpu_torch.utils import comm

    rank, world = comm.get_rank(), comm.get_world_size()
    with open(os.path.join(work, "ddp_batches.pkl"), "rb") as f:
        first = shard_input(pickle.load(f)[0], rank, world)
    grads = float64_first_gradient(work, cfg, first)
    with open(os.path.join(work, f"ddp64_rank{rank}.pkl"), "wb") as f:
        pickle.dump(grads, f)


def ddp_config(work, data_root, batch_size):
    """The shipped open-set config at full width, in float32, Mix3D off, no
    hooks, ``start_epoch`` 1, phase 6's rate."""
    from pointcloudpdf_tpu_torch.engines import default_config_parser

    return default_config_parser(CONFIG, {
        "data_root": data_root, "data.train.data_root": data_root,
        "data.val.data_root": data_root, "save_path": os.path.join(work, "exp_ddp"),
        "device": DEVICE, "batch_size": batch_size, "num_worker": 4,
        "evaluate": False, "enable_amp": False, "mix_prob": 0.0, "hooks": [],
        "seed": SEED, "recognizer.start_epoch": 1, "optimizer.lr": STEPS_LR})


def ddp_steps(trainer, batches):
    """Three ``OpenSegTrainer`` steps through ``run_step`` on ``batches``:
    one in epoch 0 (recognizer frozen), two in epoch 1 (score pass, host
    pseudo-labels, the pipelined step; the last flushed as an epoch's end
    does).  Per step: the logged outputs, the pseudo-labels trained on, a
    digest of the parameters, every ``MaskedBatchNorm``'s running
    statistics, the step's ms and its gradient all-reduce's ms; and the
    gradient the optimizer was handed at the first step."""
    import hashlib

    import torch

    from pointcloudpdf_tpu_torch.models.norm import MaskedBatchNorm

    steps, grads = [], {}
    dispatch, optimizer_step = trainer._dispatch_train, trainer.optimizer.step
    sum_gradients = trainer.sum_gradients

    def timed_sum():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sum_gradients()
        torch.cuda.synchronize()
        steps[-1]["allreduce_ms"] = (time.perf_counter() - t0) * 1e3

    def recording_step():
        if not grads:
            grads.update({n: p.grad.detach().cpu().numpy()
                          for n, p in trainer.named_parameters() if p.grad is not None})
        return optimizer_step()

    def recording_dispatch(batch, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.append({})
        dispatch(batch, *args)
        torch.cuda.synchronize()
        step = steps[-1]
        step["ms"] = (time.perf_counter() - t0) * 1e3
        step["out"] = {k: float(v) for k, v in
                       trainer.comm_info["model_output_dict"].items()}
        step["pseudo"] = batch["segment_pseudo"].cpu().numpy()
        digest = hashlib.sha1()
        for _, p in trainer.named_parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        step["params_sha1"] = digest.hexdigest()
        step["stats"] = {
            f"{name}.{mod_name}": np.concatenate([m.running_mean.cpu().numpy(),
                                                  m.running_var.cpu().numpy()])
            for name, module in trainer.modules().items()
            for mod_name, m in module.named_modules() if isinstance(m, MaskedBatchNorm)}

    trainer._dispatch_train, trainer.optimizer.step = recording_dispatch, recording_step
    trainer.sum_gradients = timed_sum
    for epoch, input_dict in zip((0, 1, 1), batches):
        trainer.epoch = epoch
        trainer.comm_info["input_dict"] = input_dict
        trainer.run_step()
    trainer._flush_pending()
    return steps, grads


def start_sheets(trainer, batches):
    """Each batch's two score sheets from the start's weights (the score
    pass ``run_step`` makes past ``start_epoch``), on the host."""
    import torch

    sheets = []
    for input_dict in batches:
        with torch.inference_mode():
            out = trainer.pseudo_forward(trainer.device_batch(input_dict))
        sheets.append([t.cpu().numpy() for t in out])
    return sheets


def graph_masks(trainer, batches, sheets):
    """The host graph stage's pseudo-labels of each batch on its score
    sheets, each item seeded by its place in the global batch."""
    return [trainer.pseudo_masks(b, *s) for b, s in zip(batches, sheets)]


def flagged_iou(a, b):
    """Intersection over union of two runs' pseudo-labelled points."""
    union = int((a | b).sum())
    return int((a & b).sum()) / union if union else 1.0


def shard_input(input_dict, rank, world):
    """A rank's items (``rank::world``) of a collated global batch."""
    out = {k: v[rank::world] if isinstance(v, np.ndarray) and v.ndim else v
           for k, v in input_dict.items()}
    out["offset"] = np.cumsum(out["count"]).astype(np.int64)
    return out


def ddp_rank(work, cfg):
    """``launch``'s ``main_func`` for phase 12(a): this rank's shard of the
    global batches through ``ddp_steps``, from the saved start, with the
    launch counts set to 0 just before and read just after; pickled to
    ``work/ddp_rank<r>.pkl``."""
    import pickle

    import torch

    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.utils import comm

    rank, world = comm.get_rank(), comm.get_world_size()
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=cfg))
    start = torch.load(os.path.join(work, "ddp_start.pt"))
    for name, module in trainer.modules().items():
        module.load_state_dict(start[name])
    with open(os.path.join(work, "ddp_batches.pkl"), "rb") as f:
        batches = [shard_input(b, rank, world) for b in pickle.load(f)]
    with open(os.path.join(work, "ddp_sheets.pkl"), "rb") as f:
        given = [[s[rank::world] for s in sheets] for sheets in pickle.load(f)]
    sheets = start_sheets(trainer, batches)
    masks = graph_masks(trainer, batches, sheets)
    seeded = graph_masks(trainer, batches, given)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    all_reduce, calls = torch.distributed.all_reduce, []

    def counted(*args, **kwargs):
        calls.append(1)
        return all_reduce(*args, **kwargs)

    torch.distributed.all_reduce = counted  # the steps' tensor all-reduces
    try:
        steps, grads = ddp_steps(trainer, batches)
    finally:
        torch.distributed.all_reduce = all_reduce
    launches = read_launches()
    launches.update(read_knn_kernels())
    result = dict(steps=steps, grads=grads, launches=launches, masks=masks,
                  sheets=sheets, seeded=seeded, all_reduces=len(calls),
                  peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                  device=str(trainer.device))
    with open(os.path.join(work, f"ddp_rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def ddp_one_process(work, data_root, batch_size, batches=None):
    """Phase 12(a)'s reference: the three steps in this process on the
    global batches, which it draws from the shipped train loader (epoch 0's
    two, epoch 1's first) and saves with the start and its score sheets for
    the ranks; or, given ``batches``, the same steps again from the saved
    start."""
    import pickle

    import torch

    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    cfg = ddp_config(work, data_root, batch_size)
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=cfg))
    drew = batches is None
    if drew:
        batches = []
        for epoch in (0, 1):
            trainer.train_loader.set_epoch(epoch)
            for input_dict in trainer.train_loader:
                batches.append(input_dict)
                if len(batches) == 2 + epoch:
                    break
        torch.save({n: m.state_dict() for n, m in trainer.modules().items()},
                   os.path.join(work, "ddp_start.pt"))
        with open(os.path.join(work, "ddp_batches.pkl"), "wb") as f:
            pickle.dump(batches, f)
    else:
        start = torch.load(os.path.join(work, "ddp_start.pt"))
        for name, module in trainer.modules().items():
            module.load_state_dict(start[name])
    sheets = start_sheets(trainer, batches)
    masks = graph_masks(trainer, batches, sheets)
    if drew:
        with open(os.path.join(work, "ddp_sheets.pkl"), "wb") as f:
            pickle.dump(sheets, f)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps, grads = ddp_steps(trainer, batches)
    launches = read_launches()
    launches.update(read_knn_kernels())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, dict(steps=steps, grads=grads, launches=launches, peak=peak,
                     masks=masks, sheets=sheets, batches=batches)


def run_ddp_training(work, data_root):
    """Phase 12(a): two gloo ranks on the card against one process on the
    same global batches and kernels.  Returns the ranks' launches (summed)
    and the numbers the phase prints."""
    import pickle

    import torch

    from pointcloudpdf_tpu_torch.engines.launch import launch

    for batch_size in DDP_SIZES:
        try:
            cfg, one = ddp_one_process(work, data_root, batch_size)
            t0 = time.perf_counter()
            launch(ddp_rank, num_gpus_per_machine=2, cfg=(work, cfg),
                   backend="gloo", device=DEVICE)
            wall = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError:
            pass
        except Exception as e:  # a rank's error comes back as its traceback
            if "OutOfMemoryError" not in str(e):
                raise
        else:
            break
        print(f"  global batch {batch_size} does not fit the card's memory")
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise SmokeFailure("no global batch fits the card's memory")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"ddp_rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    print(f"  global batch {batch_size} = 2 x {batch_size // 2} (shipped 16), ranks on "
          f"{[r['device'] for r in ranks]} (gloo); two ranks' wall {wall:.1f} s")

    # launches: a rank's equal one process's (every call is a batch's)
    for r, rank in enumerate(ranks):
        expect(rank["launches"] == one["launches"],
               f"rank {r}'s launches {rank['launches']} = one process's "
               f"{one['launches']}")
    fwd, bwd = one["launches"]["vector_attention_train"]
    expect(fwd == bwd == 18 * 3, f"K4: {fwd} forward + {bwd} backward launches a rank "
                                 f"= 18 x 3 steps")
    expect(one["launches"]["vector_attention"] == 18 * 2,
           f"K3: {one['launches']['vector_attention']} launches a rank = 18 x 2 score "
           "passes")
    expect(one["launches"]["knn"] > 0 and one["launches"]["fps"] > 0,
           f"K1 {one['launches']['knn']} and K2 {one['launches']['fps']} launches a rank")

    def interleave(parts):
        out = np.empty_like(np.concatenate(parts))
        for r, part in enumerate(parts):
            out[r::len(parts)] = part
        return out

    # from equal weights: the score sheets within TOL_DDP_SHEETS (the same
    # sums in f32, a GEMM of 8 N rows against one of 16 N rounding apart);
    # the host graph stage on one process's sheets with a rank's seeds
    # bit-equal to one process's pseudo-labels (an item's seed follows its
    # place in the global batch); on the rank's own sheets, an IoU
    sheet_gaps, start_ious = [], []
    for i, want in enumerate(one["masks"]):
        for j, ref_sheet in enumerate(one["sheets"][i]):
            got = interleave([r["sheets"][i][j] for r in ranks])
            sheet_gaps.append(float(np.abs(got - ref_sheet).max())
                              / max(float(np.abs(ref_sheet).max()), 1e-30))
        expect(np.array_equal(interleave([r["seeded"][i] for r in ranks]), want),
               f"batch {i + 1}: the graph stage on one process's score sheets with "
               f"the ranks' seeds bit-equal to one process's pseudo-labels "
               f"({int(want.sum())} points flagged)")
        start_ious.append(flagged_iou(interleave([r["masks"][i] for r in ranks]), want))
    print(f"  from the start's weights: score sheets, two ranks against one process, "
          f"largest gap {max(sheet_gaps):.3e} of max |sheet|; pseudo-labelled points "
          f"on the ranks' own sheets, IoU {start_ious}")
    expect(max(sheet_gaps) <= TOL_DDP_SHEETS,
           f"score sheets from the start's weights within {TOL_DDP_SHEETS} of one "
           f"process's")

    # one process again on the same batches, from the same start: how far
    # a second run of the same steps lands (K4's backward sums its
    # parameter gradients with atomics)
    _, again = ddp_one_process(work, data_root, batch_size, batches=one["batches"])
    repeat = [a["params_sha1"] == b["params_sha1"]
              for a, b in zip(again["steps"], one["steps"])]
    repeat_iou = [flagged_iou(a["pseudo"] == 13, b["pseudo"] == 13)
                  for a, b in zip(again["steps"], one["steps"])]
    print(f"  one process run twice: parameters equal after each step {repeat}; "
          f"pseudo-labelled points' IoU {repeat_iou}")

    (s0, s1), ref = (r["steps"] for r in ranks), one["steps"]
    expect(len(s0) == len(s1) == len(ref) == 3, "three steps in every run")
    ious = []
    for i, (a, b, want) in enumerate(zip(s0, s1, ref)):
        expect(a["out"] == b["out"], f"step {i + 1}: the ranks log the same outputs")
        for key, value in want["out"].items():
            if key == "pseudo_flagged":  # a share of points: the IoU below
                continue
            expect(abs(a["out"][key] - value) <= TOL_STEPS * abs(value),
                   f"step {i + 1} {key}: {a['out'][key]:.6f} (world 2) within "
                   f"{TOL_STEPS} of {value:.6f} (world 1)")
        ious.append(flagged_iou(interleave([a["pseudo"], b["pseudo"]]) == 13,
                                want["pseudo"] == 13))
        expect(a["params_sha1"] == b["params_sha1"],
               f"step {i + 1}: parameters equal on both ranks")
        expect(all(np.array_equal(a["stats"][k], b["stats"][k]) for k in a["stats"]),
               f"step {i + 1}: running statistics equal on both ranks "
               f"({len(a['stats'])} MaskedBatchNorms)")
        if i == 0:
            errs = sorted(
                (float(np.abs(a["stats"][key] - r).max())
                 / max(1.0, float(np.abs(r).max())), key)
                for key, r in want["stats"].items())
            worst_stats = errs[-1][0]
            print("  step 1, running statistics' largest gaps to one process's: "
                  + ", ".join(f"{k} {e:.3e}" for e, k in errs[-4:]))
            expect(worst_stats <= TOL_DDP_STATS,
                   f"step 1: running statistics within {TOL_DDP_STATS} of one "
                   f"process's (worst {worst_stats:.3e} at {errs[-1][1]})")
    # after an update the score passes read running statistics that differ
    # by the f32 order of their sums (above), and the host graph stage
    # flips points: reported, not held (the seeds are held above, from
    # equal weights)
    print(f"  pseudo-labelled points of the steps, two ranks against one process: "
          f"IoU {ious}")
    flagged = [s["out"].get("pseudo_flagged", 0.0) for s in ref]
    expect(flagged[0] == 0.0 and min(flagged[1:]) > 0.0,
           f"pseudo-labelling fired past start_epoch: {flagged}")
    check_first_gradient(work, cfg, one, ranks, again)
    step_ms = {w: [s["ms"] for s in steps] for w, steps in ((1, ref), (2, s0))}
    allreduce_ms = [s["allreduce_ms"] for s in s0]
    print(f"  step ms (host clock, synchronised): world 1 {step_ms[1]}, world 2 "
          f"{step_ms[2]}; gradient all-reduce ms (gloo, world 2) {allreduce_ms}; "
          f"tensor all-reduces a rank over the three steps "
          f"{[r['all_reduces'] for r in ranks]}")
    print(f"  peak device memory: world 1 {one['peak']:.2f} GiB, world 2 a rank "
          f"{[round(r['peak'], 2) for r in ranks]} GiB")
    launches = {}  # both ranks' (K7 by width left out: no PT-v2 here)
    for key, n in ranks[0]["launches"].items():
        m = ranks[1]["launches"][key]
        if isinstance(n, tuple):
            launches[key] = tuple(x + y for x, y in zip(n, m))
        elif not isinstance(n, dict):
            launches[key] = n + m
    return launches, dict(batch_size=batch_size, step_ms=step_ms,
                          allreduce_ms=allreduce_ms, peak=[r["peak"] for r in ranks],
                          one_peak=one["peak"], wall=wall, cfg=cfg,
                          all_reduces=ranks[0]["all_reduces"])


def check_first_gradient(work, cfg, one, ranks, again):
    """The first step's f32 gradient, two ranks against one process, held
    against the float64 gradient of one process on the plain versions
    (same batch, same start), as ``tests/test_torch_cac_losses.py``'s
    ``assert_gradient_triple`` holds a gradient: each f32 gradient within
    ``TOL_GRAD_WHOLE`` of float64 as a whole; a tensor of the ranks within
    ``TOL_GRAD`` of float64 or of one process's, except where one process's
    is itself more than ``TOL_GRAD`` off float64 (a gradient at the level of
    f32 noise): there the ranks' within ``TOL_GRAD`` of float64, or closer
    to it than one process's.  (Two f32 gradients each within ``TOL_GRAD``
    of float64 can sit up to twice that apart: held to one process alone,
    the ranks failed two of three repeated runs on an H100 at 0.252 and
    0.261 where both were within 0.25 of float64.)  Then the float64 gradient of two
    gloo ranks on the plain versions against one process's within
    ``TOL_FLOAT64_RANKS``: the semantic check of the sums over ranks."""
    import pickle

    from pointcloudpdf_tpu_torch.engines.launch import launch

    exact = float64_first_gradient(work, cfg, one["batches"][0])
    launch(ddp_float64_rank, num_gpus_per_machine=2, cfg=(work, cfg), backend="gloo",
           device=DEVICE)
    rank64 = []
    for r in range(2):
        with open(os.path.join(work, f"ddp64_rank{r}.pkl"), "rb") as f:
            rank64.append(pickle.load(f))
    expect(set(ranks[0]["grads"]) >= set(exact) and set(one["grads"]) >= set(exact),
           f"the f32 gradients hold the {len(exact)} tensors of the float64 one")
    ro, ro_whole = gradient_errors(ranks[0]["grads"], one["grads"])
    of, of_whole = gradient_errors(one["grads"], exact)
    rf, rf_whole = gradient_errors(ranks[0]["grads"], exact)
    af, af_whole = gradient_errors(again["grads"], exact)
    for name, errors, whole in (("world 2 - world 1", ro, ro_whole),
                                ("world 1 - float64", of, of_whole),
                                ("world 2 - float64", rf, rf_whole),
                                ("world 1 again - float64", af, af_whole)):
        top = sorted(errors, key=errors.get)[-3:][::-1]
        print(f"  first step's gradient, {name}: worst tensors "
              f"{[(k, round(errors[k], 4)) for k in top]}, whole {whole:.3e}")
    expect(of_whole <= TOL_GRAD_WHOLE and rf_whole <= TOL_GRAD_WHOLE,
           f"first step's f32 gradients within {TOL_GRAD_WHOLE} of float64 as a whole")
    noisy = sorted(k for k in exact if of[k] > TOL_GRAD)
    print(f"  tensors where world 1's f32 gradient is over {TOL_GRAD} off float64 "
          f"(held against float64): {[(k, round(of[k], 3), round(rf[k], 3)) for k in noisy]}")
    failing = [k for k in exact if rf[k] > TOL_GRAD
               and (rf[k] >= of[k] if k in noisy else ro[k] > TOL_GRAD)]
    expect(not failing, f"first step's gradient, {len(exact)} tensors: world 2 within "
                        f"{TOL_GRAD} of float64 or of world 1, or where world 1 is over "
                        f"{TOL_GRAD} off float64, closer to it than world 1; failing "
                        f"(tensor, world 2 - world 1, world 1 - float64, world 2 - float64) "
                        f"{[(k, ro[k], of[k], rf[k]) for k in failing]}")
    for r, grads in enumerate(rank64):
        worst, _ = gradient_gap(grads, exact)
        print(f"  float64 gradient, rank {r} of 2 against one process: worst tensor "
              f"{worst[0]:.3e} ({worst[1]})")
        expect(set(grads) == set(exact) and worst[0] <= TOL_FLOAT64_RANKS,
               f"float64: rank {r}'s summed gradient within {TOL_FLOAT64_RANKS} of one "
               "process's")


def one_step(trainer, input_dict, out, grouped):
    """One step past ``start_epoch`` (score pass, pseudo-labels, the step);
    ``launch``'s ``main_func`` for phase 12(b), in a group of one where
    ``grouped``."""
    from pointcloudpdf_tpu_torch.utils import comm

    expect(comm.is_distributed() == grouped and comm.get_world_size() == 1,
           "an NCCL group of one" if grouped else "no process group")
    trainer.epoch = 1
    trainer.comm_info["input_dict"] = input_dict
    trainer.run_step()
    trainer._flush_pending()
    out.update({k: float(v) for k, v in trainer.comm_info["model_output_dict"].items()})


def run_nccl_world_one(work, ddp):
    """Phase 12(b): one step through ``launch(backend="nccl")`` at world 1,
    every collective of the path issued, against the same step without
    ``launch`` (two crops of phase 12(a)'s third batch)."""
    import copy
    import pickle

    import torch

    from pointcloudpdf_tpu_torch.engines.launch import launch
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    cfg = copy.deepcopy(ddp["cfg"])
    cfg.batch_size = 2
    with open(os.path.join(work, "ddp_batches.pkl"), "rb") as f:
        input_dict = shard_input(pickle.load(f)[2], 0, ddp["batch_size"] // 2)
    start = torch.load(os.path.join(work, "ddp_start.pt"))
    outs = []
    for through_launch in (False, True, False):
        torch.manual_seed(SEED)
        trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=cfg))
        for name, module in trainer.modules().items():
            module.load_state_dict(start[name])
        out = {}
        if through_launch:
            launch(one_step, num_gpus_per_machine=1,
                   cfg=(trainer, input_dict, out, True), backend="nccl", device=DEVICE)
        else:
            one_step(trainer, input_dict, out, False)
        outs.append(out)
        del trainer
    print(f"  outputs without launch {outs[0]}, through launch (NCCL, world 1) "
          f"{outs[1]}, without again {outs[2]}")
    expect(outs[0] == outs[2], "the step repeats bit for bit without launch")
    expect(outs[1] == outs[0], "the step through launch (NCCL, world 1) equals it "
                               "bit for bit")


def run_ddp_tester(work):
    """Phase 12(c): ``tools/test_torch.py``'s path (``test_worker``) on two
    gloo ranks over phase 4's room and a second one, against one process:
    pred and score files bit-equal, the same metrics; phase 4's room's
    files bit-equal to phase 4's."""
    import shutil

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.launch import launch
    from pointcloudpdf_tpu_torch.engines.test import test_worker

    data_root = os.path.join(work, "s3dis_ddp_test")
    os.makedirs(os.path.join(data_root, "Area_5"))
    shutil.copy(os.path.join(work, "s3dis_pt", "Area_5", "office_1.npz"),
                os.path.join(data_root, "Area_5", "office_1.npz"))
    synthetic_room(np.random.RandomState(SEED + 5),
                   os.path.join(data_root, "Area_5", "office_2.npz"))
    weight = os.path.join(work, "model_pt.pth")

    def options(world):
        return {"data_root": data_root, "data.test.data_root": data_root,
                "weight": weight, "save_path": os.path.join(work, f"exp_ddp_test_w{world}"),
                "device": DEVICE}

    t0 = time.perf_counter()
    log1 = run_tool("test_torch.py", [
        "--config-file", CONFIG, "--device", DEVICE, "--options",
        *(f"{k}={v}" for k, v in options(1).items())])
    t1 = time.perf_counter()
    launch(test_worker, num_gpus_per_machine=2,
           cfg=(default_config_parser(CONFIG, options(2)),), backend="gloo",
           device=DEVICE)
    t2 = time.perf_counter()
    with open(os.path.join(options(2)["save_path"], "train.log")) as f:
        log2 = f.read()
    print(f"  tester over 2 rooms: one process {t1 - t0:.1f} s, two gloo ranks "
          f"{t2 - t1:.1f} s")
    results = [os.path.join(options(w)["save_path"], "result") for w in (1, 2)]
    names = sorted(os.listdir(results[0]))
    expect(len(names) == 4 and sorted(os.listdir(results[1])) == names,
           f"pred and score files of both rooms from both runs: {names}")
    for name in names:
        a, b = (np.load(os.path.join(d, name)) for d in results)
        expect(np.array_equal(a, b), f"{name}: two ranks' file bit-equal to one "
                                     "process's")
        if name.startswith("office_1"):
            c = np.load(os.path.join(work, "exp_pt", "result", name))
            expect(np.array_equal(b, c), f"{name}: bit-equal to phase 4's")
    import re

    val = [re.findall(r"Val result: [^\n]*", log) for log in (log1, log2)]
    print("  " + "\n  ".join(val[1]))
    expect(len(val[0]) == 3 and val[0] == val[1],
           "rank 0 reports one process's metrics")


def run_ddp_slice(work, data_root):
    """Phase 12: (a), (b) and (c)."""
    print("  (a) two gloo ranks on the card, the shipped open-set config")
    launches, ddp = run_ddp_training(work, data_root)
    print("  (b) NCCL at world 1")
    run_nccl_world_one(work, ddp)
    print("  (c) the tester on two gloo ranks")
    run_ddp_tester(work)
    return launches, ddp


# ---------------------------------------------------------------------------
# phase 13: the SpUNet family (no kernel of its own: its gather-GEMM-scatter
# conv is PyTorch's index_select, mm and index_add over the exact rulebook)

SPUNET_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-spunet-v1m1-0-base.py")
MINK_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-minkunet34c-0-base.py")
CAC_SPUNET_CONFIG = os.path.join(ROOT, "configs", "scannet",
                                 "semseg-cac-v1m1-0-spunet-base.py")
SPUNET_M3_CONFIG = os.path.join(ROOT, "configs", "scannet",
                                "semseg-spunet-v1m3-0-pdnorm-base.py")
SPUNET_TRAIN_BATCHES = PTV2_TRAIN_BATCHES  # the shipped 12, its halves, 2 and 1
TOL_SPUNET_LOGITS = 1e-4  # a fragment's logits, card against CPU, of max |logit|
# the share of a training step in PyTorch's sort-based backward of advanced
# indexing: the rulebook conv gathers with index_select (a scatter-add
# backward), so none is expected
MAX_INDEXING_BACKWARD_SHARE = 0.05


def no_kernel_launched(launches, what):
    counts = {k: (sum(v) if isinstance(v, tuple) else v) for k, v in launches.items()
              if k != "gva_by_width"}
    expect(not any(counts.values()), f"{what} launched no kernel of K1-K7: {counts}")


def check_fragment_maps(tester, fragment, batch, name="SpUNet",
                          keys=("nbr5", "nbr3", "grid", "mask", "c2p"),
                          tol=TOL_SPUNET_LOGITS, conditions=(None,), cpu_crop=None):
    """The largest fragment's voxel maps built on the card equal the CPU's
    bit for bit (``keys`` of the backbone's ``index_maps``: every level's
    neighbour table, the stem's, the parent maps and masks; PT-v3's curve
    sorts), and its logits on the card are within ``tol`` of max |logit| of
    the port's CPU forward, under each of ``conditions`` (the batch's own
    where None); with ``cpu_crop`` the logits of that share of the fragment
    (``crop_fragment``: the script's time limit), or of the fragment that
    ``cpu_crop(fragment)`` returns.  Returns each condition's
    logits' class count."""
    import copy

    import torch

    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn
    from pointcloudpdf_tpu_torch.ops import voxel

    backbone = tester.model.backbone
    cpu_model = copy.deepcopy(tester.model).cpu()
    cpu_batch = {k: v.cpu() if torch.is_tensor(v) else v for k, v in batch.items()}
    with torch.inference_mode():
        maps = backbone.index_maps(batch["grid_coord"], batch["mask"])
        ref = cpu_model.backbone.index_maps(cpu_batch["grid_coord"], cpu_batch["mask"])
    if cpu_crop is not None:
        part = (cpu_crop(fragment) if callable(cpu_crop)
                else crop_fragment(fragment, cpu_crop))
        batch = tester.device_batch(padded_collate_fn([part]))
        cpu_batch = {k: v.cpu() if torch.is_tensor(v) else v for k, v in batch.items()}
        print(f"  logits compared on a crop of {int(batch['mask'].sum())} points")
    compared = [(f"{key}[{i}]", a, b) for key in keys
                for i, (a, b) in enumerate(zip(*(
                    (m[key] if isinstance(m[key], list) else [m[key]]) for m in (maps, ref))))]
    differ = [label for label, a, b in compared if not torch.equal(a.cpu(), b)]
    expect(not differ, f"{len(compared)} {name} voxel maps ({', '.join(keys)}) equal on "
                       f"the card and the CPU bit for bit; differ: {differ}")
    pairs = [int((t >= 0).sum()) for t in [maps["nbr5"], *maps["nbr3"]]]
    print(f"  level sizes {[int(m.sum()) for m in maps['mask']]} voxels, rulebook pairs "
          f"(5^3 stem, 3^3 levels) {pairs}")
    voxel.capacity_dropped_points(reset=True)
    classes = {}
    for condition in conditions:
        named = {} if condition is None else {"condition_name": condition}
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = tester.forward(dict(batch, **named))["seg_logits"].cpu()
            cpu = cpu_model(dict(cpu_batch, **named))["seg_logits"]
        lmax = float(cpu.abs().max())
        lerr = float((out - cpu).abs().max())
        print(f"  fragment logits{'' if condition is None else ' under ' + condition}, card "
              f"against CPU: err {lerr:.3e} (max |logit| {lmax:.3e}), {out.shape[-1]} classes "
              f"({time.perf_counter() - t0:.1f} s)")
        expect(lerr <= tol * lmax,
               f"{name} logits on the card within {tol} x max |logit| of the CPU's")
        classes[condition] = out.shape[-1]
    dropped = voxel.capacity_dropped_points(reset=True)
    expect(dropped == 0, f"{dropped} points dropped by the level capacities in the fragment")
    return classes


def profile_train_step(work, data_root, batch_size, config=SPUNET_CONFIG, name="SpUNet",
                       report=None):
    """One batch of ``config`` (the shipped S3DIS SpUNet config) at
    ``batch_size``: the train step's ms by CUDA events (three after a
    warm-up), its peak device memory and, from ``torch.profiler``, the share
    of its device time in PyTorch's ``indexing_backward_kernel``;
    ``report(model, batch)``'s dict joins the result."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _profile_torch import profile_call

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    cfg = default_config_parser(config, {
        "data_root": data_root, "data.train.data_root": data_root,
        "data.train.split": (f"Batch{batch_size}",), "save_path": os.path.join(
            work, f"exp_{name}_profile"), "device": DEVICE, "batch_size": batch_size,
        "num_worker": 0, "evaluate": False, "hooks": [], "seed": SEED})
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=cfg))
    input_dict = next(iter(trainer.train_loader))
    batch = trainer.device_batch(input_dict)
    trainer._dispatch_train(batch)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        trainer._dispatch_train(batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t2 = time.perf_counter()
    prof = profile_call(lambda: trainer._dispatch_train(batch), step_ms, f"{name} step",
                        top=8)
    print(f"  (profile_train_step: trainer, batch and warm-up {t1 - t0:.1f} s, timed steps "
          f"{t2 - t1:.1f} s, profiled step {time.perf_counter() - t2:.1f} s)")
    share = prof["indexing_backward_ms"] / prof["device_busy_ms"]
    print(f"  {name} train step, batch {list(batch['coord'].shape)} (valid points "
          f"{input_dict['count'].tolist()}): {step_ms:.1f} ms (CUDA events), peak "
          f"{peak:.2f} GiB; indexing_backward_kernel {prof['indexing_backward_ms']:.3f} "
          f"ms, {share:.4f} of {prof['device_busy_ms']:.1f} ms busy")
    expect(share <= MAX_INDEXING_BACKWARD_SHARE,
           f"indexing backward share {share:.4f} <= {MAX_INDEXING_BACKWARD_SHARE}")
    extra = {} if report is None else report(trainer.model, batch)
    return dict(step_ms=step_ms, peak=peak, share=share, idle=prof["idle_share_unprofiled"],
                busy_ms=prof["device_busy_ms"], shape=list(batch["coord"].shape), **extra)


def scannet_grid_batch(trainer, data_root, rooms=2):
    """``CAC_POINTS`` voxels of each of two synthetic rooms at the ScanNet
    configs' grid (2 cm; the first point of a voxel), 6 channels
    (coordinates, colours), labels clipped to ScanNet's 20 classes."""
    rng = np.random.RandomState(SEED + 3)
    paths = sorted(glob.glob(os.path.join(data_root, TRAIN_AREAS[0], "*.npz")))[:rooms]
    keys = ("coord", "grid_coord", "feat", "segment")
    out = {k: [] for k in keys}
    for path in paths:
        room = np.load(path)
        grid = np.floor((room["coord"] - room["coord"].min(0)) / 0.02).astype(np.int32)
        first = np.unique(grid, axis=0, return_index=True)[1]
        keep = first[rng.permutation(len(first))[:CAC_POINTS]]
        coord = room["coord"][keep]
        values = dict(coord=coord, grid_coord=grid[keep],
                      feat=np.concatenate([coord - coord.mean(0),
                                           room["color"][keep] / 255.0], 1),
                      segment=np.minimum(room["semantic_gt"][keep], 19))
        for k in keys:
            pad = [(0, CAC_BUCKET - len(coord))] + [(0, 0)] * (values[k].ndim - 1)
            out[k].append(np.pad(values[k], pad, constant_values=-1 if k == "segment" else 0))
    batch = {k: np.stack(v) for k, v in out.items()}
    batch["coord"] = batch["coord"].astype(np.float32)
    batch["feat"] = batch["feat"].astype(np.float32)
    batch["segment"] = batch["segment"].astype(np.int64)
    batch["count"] = np.full(rooms, CAC_POINTS, np.int32)
    return trainer.device_batch(batch)


def one_step_and_eval(config, work, name, options, make_batch):
    """One ``DefaultTrainer`` step and one eval forward of ``config`` at full
    width on the batch ``make_batch(trainer)``: finite outputs, no kernel
    of K1-K7 launched.  Returns (trainer, batch, step outputs, eval logits)."""
    import torch

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    cfg = default_config_parser(config, dict({
        "device": DEVICE, "batch_size": 2, "num_worker": 0, "evaluate": False,
        "hooks": [], "seed": SEED, "save_path": os.path.join(work, f"exp_{name}")},
        **options))
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=cfg))
    batch = make_batch(trainer)
    reset_launches()
    trainer._dispatch_train(batch)
    out = {k: float(v) for k, v in trainer.comm_info["model_output_dict"].items()}
    logits = trainer.eval_step(batch)["seg_logits"]
    no_kernel_launched(read_launches(), f"{name}'s step and eval forward")
    expect(all(np.isfinite(v) for v in out.values())
           and bool(torch.isfinite(logits).all()), f"{name}: finite loss and logits")
    print(f"  {name}: step on {list(batch['coord'].shape)}: {out}; eval logits "
          f"{list(logits.shape)}")
    return trainer, batch, out, logits


def run_spunet_slice(work, data_root, n_val):
    """Phase 13: (a) serving, (b) training, (c) the other entries."""
    import re

    import torch

    from pointcloudpdf_tpu_torch.models import build_model
    from pointcloudpdf_tpu_torch.ops import voxel
    from pointcloudpdf_tpu_torch.utils.config import Config

    print("  (a) tools/test_torch.py on the shipped S3DIS SpUNet config")
    t0 = time.perf_counter()
    serving = run_slice(work, SPUNET_CONFIG, "spunet", per_forward={},
                        fragment_check=check_fragment_maps)
    walls = {"a": time.perf_counter() - t0}

    print("  (b) tools/train_torch.py on it at full width, then the tester")
    t0 = time.perf_counter()
    split_root = two_batch_splits(work, data_root)
    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, SPUNET_CONFIG, "spunet_train", split_root, 1,
        [f"data.test.data_root={data_root}"], subsample=False,
        sizes=SPUNET_TRAIN_BATCHES, areas=lambda b: (f"Batch{b}",))
    dropped = voxel.capacity_dropped_points(reset=True)
    no_kernel_launched(launches, "SpUNet training and its evaluator")
    losses = train_log_losses(log, iters)["loss"]
    print(f"  losses {losses}; dropped by the level capacities {dropped}")
    for line in re.findall(r"Val result: [^\n]*", log):
        print("  " + line)
    expect(all(np.isfinite(losses)), "finite losses")
    expect("Val result: mIoU/mAcc/allAcc" in log, "the evaluator ran")
    expect(dropped == 0, f"{dropped} points dropped by the level capacities")
    weight = os.path.join(save_path, "model", "model_last.pth")
    test_save = os.path.join(work, "exp_spunet_train_test")
    reset_launches()
    log = run_tool("test_torch.py", [
        "--config-file", SPUNET_CONFIG, "--device", DEVICE, "--options",
        f"data_root={data_root}", f"weight={weight}", f"save_path={test_save}",
        f"data.test.data_root={data_root}"])
    no_kernel_launched(read_launches(), "the tester on the trained checkpoint")
    pred = np.load(glob.glob(os.path.join(test_save, "result", "*_pred.npy"))[0])
    expect("Val result: mIoU/mAcc/allAcc" in log and pred.shape == (n_val,),
           f"tools/test_torch.py tested the trainer's checkpoint: pred of {n_val} points")
    gc.collect()
    torch.cuda.empty_cache()
    step = profile_train_step(work, split_root, batch_size)
    step.update(batch_size=batch_size, train_peak=peak, train_wall=wall)
    walls["b"] = time.perf_counter() - t0

    print("  (c) MinkUNet34C, CAC-v1m1 over SpUNet, SpUNet-v1m3")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    split = {"data_root": split_root, "data.train.data_root": split_root,
             "data.train.split": ("Batch2",)}
    one_step_and_eval(MINK_CONFIG, work, "MinkUNet34C", split,
                      lambda t: t.device_batch(next(iter(t.train_loader))))
    _, batch, out, _ = one_step_and_eval(
        CAC_SPUNET_CONFIG, work, "CAC-v1m1 over SpUNet", {},
        lambda t: scannet_grid_batch(t, data_root))
    expect(set(out) == {"loss", "seg_loss", "pre_loss", "pre_self_loss", "kl_loss"},
           "CAC: the model's loss and its four parts")
    cfg = Config.fromfile(SPUNET_M3_CONFIG)
    torch.manual_seed(SEED)
    model = randomise_bn(build_model(dict(cfg.model)), torch.Generator().manual_seed(SEED))
    model = model.to(DEVICE).eval()
    reset_launches()
    logits = {}
    with torch.inference_mode():
        for condition in cfg.model.backbone.conditions:
            logits[condition] = model(dict(batch, condition_name=condition))["seg_logits"]
    no_kernel_launched(read_launches(), "SpUNet-v1m3's forwards")
    names = list(logits)
    gaps = [float((logits[a] - logits[b]).abs().max()) for a, b in zip(names, names[1:])]
    print(f"  SpUNet-v1m3: eval forwards under {names}, logits "
          f"{list(logits[names[0]].shape)}; max gap between conditions {gaps}")
    expect(all(bool(torch.isfinite(v).all()) for v in logits.values()) and min(gaps) > 0,
           "SpUNet-v1m3: finite logits, a bank of its own a condition")
    walls["c"] = time.perf_counter() - t0
    print(f"  phase 13 walls (s): (a) {walls['a']:.1f}, (b) {walls['b']:.1f}, "
          f"(c) {walls['c']:.1f}")
    return serving, step



# ---------------------------------------------------------------------------
# phase 14: PT-v3m1 (no kernel of its own: its patch attention is plain
# PyTorch, as the JAX package's is plain jnp; the xCPE convs are phase 13's
# rulebook conv)

PTV3_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-pt-v3m1-0-rpe.py")
PTV3_SCANNET_CONFIG = os.path.join(ROOT, "configs", "scannet", "semseg-pt-v3m1-0-base.py")
# the shipped 12, 6 and 3 do not fit one H100 80GB (PERF.md §5):
# the script no longer spends its time limit on showing it again
PTV3_TRAIN_BATCHES = (2, 1)
# a fragment's logits, card against CPU, of max |logit|: f32 on both (TF32
# off), 22 blocks of softmax attention summed in other orders
TOL_PTV3_LOGITS = 1e-4
PTV3_MAP_KEYS = ("nbr5", "nbr3", "grid", "mask", "c2p", "order", "inverse")
# phase 14's rooms: phases 4 and 5's layouts with normals, at four times
# their density.  The config pools 2 cm voxels into half capacities, which
# holds on a scanned surface (a 4 cm parent holds several 2 cm children);
# at 700 points a square metre most 2 cm voxels are alone in their parent
# and the capacities drop points (154,299 over the 14 fragments of phase
# 4's room, counted on the CPU at a reduced width).  A real S3DIS room holds
# ~10^4 points a square metre.
PTV3_ROOM = dict(normals=True, density=2800)


def ptv3_fragment_check(tester, fragment, batch):
    """PT-v3's largest fragment: its voxel maps and the four curve sorts of
    every level on the card equal the CPU's bit for bit, its logits within
    ``TOL_PTV3_LOGITS`` of the CPU forward's, nothing dropped; then one
    forward under ``torch.profiler`` (the device's busy time and idle
    share)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _profile_torch import profile_call

    check_fragment_maps(tester, fragment, batch, name="PT-v3", keys=PTV3_MAP_KEYS,
                          tol=TOL_PTV3_LOGITS, cpu_crop=CPU_CROP)

    def forward():
        with torch.inference_mode():
            tester.forward(batch)

    ms = cuda_ms(forward, 3)
    prof = profile_call(forward, ms, "PT-v3 fragment forward", top=8)
    ptv3_fragment_check.result = dict(ms=ms, points=int(batch["mask"].sum()),
                                      bucket=int(batch["mask"].shape[1]),
                                      busy_ms=prof["device_busy_ms"],
                                      idle=prof["idle_share_unprofiled"])


def run_ptv3_slice(work, data_root):
    """Phase 14: (a) serving the shipped S3DIS PT-v3m1 -rpe config, (b)
    training it at full width, (c) a step and eval forward of the ScanNet
    config."""
    import re

    import torch

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.ops import voxel
    from pointcloudpdf_tpu_torch.utils.checkpoint import load_checkpoint

    print("  (a) tools/test_torch.py on the shipped S3DIS PT-v3m1 -rpe config")
    t0 = time.perf_counter()
    serving = run_slice(work, PTV3_CONFIG, "ptv3", per_forward={},
                        fragment_check=ptv3_fragment_check, room=PTV3_ROOM)
    serving_fragment = ptv3_fragment_check.result
    walls = {"a": time.perf_counter() - t0}

    print("  (b) tools/train_torch.py on it at full width (phase 5's layouts, "
          f"{PTV3_ROOM}), then the tester")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    normals_root, n_val = make_train_rooms(work, "s3dis_train_ptv3", **PTV3_ROOM)
    split_root = two_batch_splits(work, normals_root, "s3dis_two_batches_normals")
    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, PTV3_CONFIG, "ptv3_train", split_root, 1,
        [f"data.test.data_root={normals_root}"], subsample=False,
        sizes=PTV3_TRAIN_BATCHES, areas=lambda b: (f"Batch{b}",))
    dropped = voxel.capacity_dropped_points(reset=True)
    no_kernel_launched(launches, "PT-v3 training and its evaluator")
    losses = train_log_losses(log, iters)["loss"]
    print(f"  losses {losses}; dropped by the level capacities {dropped}")
    for line in re.findall(r"Val result: [^\n]*", log):
        print("  " + line)
    expect(all(np.isfinite(losses)), "finite losses")
    expect("Val result: mIoU/mAcc/allAcc" in log, "the evaluator ran")
    expect(dropped == 0, f"{dropped} points dropped by the level capacities")
    weight = os.path.join(save_path, "model", "model_last.pth")
    test_save = os.path.join(work, "exp_ptv3_train_test")
    reset_launches()
    log = run_tool("test_torch.py", [
        "--config-file", PTV3_CONFIG, "--device", DEVICE, "--options",
        f"data_root={normals_root}", f"weight={weight}", f"save_path={test_save}",
        f"data.test.data_root={normals_root}"])
    no_kernel_launched(read_launches(), "the tester on the trained checkpoint")
    pred = np.load(glob.glob(os.path.join(test_save, "result", "*_pred.npy"))[0])
    expect("Val result: mIoU/mAcc/allAcc" in log and pred.shape == (n_val,),
           f"tools/test_torch.py tested the trainer's checkpoint: pred of {n_val} points")
    gc.collect()
    torch.cuda.empty_cache()
    step = profile_train_step(work, split_root, batch_size, PTV3_CONFIG, "PT-v3")
    step.update(batch_size=batch_size, train_peak=peak, train_wall=wall)
    gc.collect()
    torch.cuda.empty_cache()

    # the evaluator's batches carry the config's origin_coord / origin_segment;
    # one step's loss under autocast against f32
    cfg = default_config_parser(PTV3_CONFIG, {
        "data_root": split_root, "data.train.data_root": split_root,
        "data.train.split": ("Batch1",), "data.val.data_root": split_root,
        "save_path": os.path.join(work, "exp_ptv3_check"), "device": DEVICE,
        "batch_size": 1, "num_worker": 0, "hooks": [], "seed": SEED, "mix_prob": 0.0})
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=cfg))
    trainer.load_state_dict(load_checkpoint(weight)["state"])
    val = next(iter(trainer.val_loader))
    expect("origin_coord" in val and "origin_segment" in val,
           "the evaluator's batches hold origin_coord and origin_segment")
    batch = trainer.device_batch(next(iter(trainer.train_loader)))
    step_losses = {}
    for amp in (False, True):
        trainer.cfg.enable_amp = amp
        trainer._train_mode(True)
        trainer.generator.manual_seed(SEED)
        with torch.no_grad(), trainer._amp():
            loss, _ = trainer.compute_loss(trainer.forward_train(trainer.model, batch), batch)
        step_losses[amp] = float(loss)
    f32, amp = step_losses[False], step_losses[True]
    print(f"  one step's loss on {list(batch['coord'].shape)}: f32 {f32:.6f}, bfloat16 "
          f"autocast {amp:.6f}")
    expect(np.isfinite(amp) and abs(amp - f32) <= TOL_AMP_LOGITS * abs(f32),
           f"the autocast loss finite and within {TOL_AMP_LOGITS} of the f32 loss")
    del trainer, batch, val
    walls["b"] = time.perf_counter() - t0

    print("  (c) the shipped ScanNet PT-v3m1 config: a step and an eval forward")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    one_step_and_eval(PTV3_SCANNET_CONFIG, work, "PT-v3m1 ScanNet", {},
                      lambda t: scannet_grid_batch(t, data_root))
    scannet_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  PT-v3m1 ScanNet: peak {scannet_peak:.2f} GiB (patches of 1,024, no RPE)")
    walls["c"] = time.perf_counter() - t0
    print(f"  phase 14 walls (s): (a) {walls['a']:.1f}, (b) {walls['b']:.1f}, "
          f"(c) {walls['c']:.1f}")
    step.update(serving=serving_fragment, scannet_peak=scannet_peak, amp_loss=amp,
                f32_loss=f32)
    return serving, step


# ---------------------------------------------------------------------------
# phase 15: Point Prompt Training (no kernel of its own: PPT's context and
# cosine head are plain PyTorch over phase 13's SpUNet-v1m3 and phase 14's
# PT-v3)

PPT_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-ppt-v1m1-0-s3-sc-st-spunet.py")
PPT_V3_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-pt-v3m1-1-ppt-extreme.py")
PPT_V1M2_CONFIG = os.path.join(ROOT, "configs", "semantic_kitti",
                               "semseg-ppt-v1m2-0-sk-nu-wa-spunet.py")
# the shipped 12, 6 and 3 (PPT) and 24, 12, 6 and 2 (PPT-extreme) do not fit
# one H100 80GB (PERF.md): not tried again, for the time limit
PPT_TRAIN_BATCHES = (2, 1)
PPT_V3_BATCHES = (1,)
PPT_DISTINCT_ROOMS = 4                 # rooms a layout; a split links them over
# the dataset a batch came from (its sub-loader's) and the condition its
# samples must carry
PPT_SOURCES = {"Structured3DDataset": "Structured3D", "ScanNetDataset": "ScanNet",
               "S3DISDataset": "S3DIS"}
# S3DIS's 13 classes in ScanNet's 20 and Structured3D's 25, by PPT's class
# names (-1 where ScanNet has no such class)
S3DIS_TO_SCANNET = np.array([-1, 1, 0, -1, -1, 8, 7, 6, 4, 5, 9, 10, 19])
S3DIS_TO_STRUCTURED3D = np.array([16, 1, 0, 22, 22, 8, 7, 6, 4, 5, 11, 9, 24])


def ppt_rooms(work):
    """Phase 15's scenes under ``work/ppt``: phase 14's rooms (``PTV3_ROOM``;
    made here when phase 14 has not run) in the three layouts of the PPT
    configs, ``PPT_DISTINCT_ROOMS`` of them relabelled into Structured3D's
    (``structured3d/rooms``) and ScanNet's (``scannet/rooms``, as
    ``semantic_gt20``) class spaces, and the S3DIS val area; the splits a
    batch size takes are links (``ppt_splits``).  Returns the root."""
    s3dis_root = os.path.join(work, "s3dis_train_ptv3")
    if not os.path.isdir(s3dis_root):
        s3dis_root, _ = make_train_rooms(work, "s3dis_train_ptv3", **PTV3_ROOM)
    root = os.path.join(work, "ppt")
    rooms = sorted(glob.glob(os.path.join(s3dis_root, "Area_[1-46]", "*.npz")))
    for sub in ("structured3d/rooms", "scannet/rooms", "s3dis/rooms"):
        os.makedirs(os.path.join(root, sub))
    os.symlink(os.path.join(s3dis_root, "Area_5"), os.path.join(root, "s3dis", "Area_5"))
    for i, path in enumerate(rooms[:PPT_DISTINCT_ROOMS]):
        room = dict(np.load(path))
        label = room.pop("semantic_gt")
        np.savez(os.path.join(root, "structured3d", "rooms", f"{i}.npz"),
                 semantic_gt=S3DIS_TO_STRUCTURED3D[label], **room)
        np.savez(os.path.join(root, "scannet", "rooms", f"{i}.npz"),
                 semantic_gt20=S3DIS_TO_SCANNET[label], **room)
        os.symlink(path, os.path.join(root, "s3dis", "rooms", f"{i}.npz"))
    return root


def ppt_splits(root, batch_size):
    """The train splits of one batch size: 2 b Structured3D scenes
    (``train_b<b>/scene_<j>/room_0.npz``), b ScanNet scenes and b S3DIS rooms,
    linked over the distinct rooms: an epoch of four steps at the datasets'
    ratios 2 : 1 : 1.  Returns each dataset's (data root, split)."""
    split = f"train_b{batch_size}"
    layouts = (("structured3d", 2 * batch_size, "scene_{j:05d}/room_0.npz"),
               ("scannet", batch_size, "scene{j:04d}_00.npz"),
               ("s3dis", batch_size, "office_{j}.npz"))
    for sub, count, name in layouts:
        base = os.path.join(root, sub, split)
        if os.path.isdir(base):
            continue
        for j in range(count):
            link = os.path.join(base, name.format(j=j))
            os.makedirs(os.path.dirname(link), exist_ok=True)
            os.symlink(os.path.join(root, sub, "rooms", f"{j % PPT_DISTINCT_ROOMS}.npz"),
                       link)
    return [(os.path.join(root, sub), split if sub != "s3dis" else (split,))
            for sub, _, _ in layouts]


def ppt_test_data(data_root):
    """A ``data.test`` for the S3DIS PPT configs, which ship none: fragment
    voting over the Area_5 rooms at the configs' 2 cm grid, each fragment
    under condition ``S3DIS`` (``Add`` in the post-transform)."""
    return dict(
        type="S3DISDataset", split="Area_5", data_root=data_root, test_mode=True,
        transform=[dict(type="CenterShift", apply_z=True), dict(type="NormalizeColor")],
        test_cfg=dict(
            voxelize=dict(type="GridSample", grid_size=0.02, hash_type="fnv", mode="test",
                          keys=("coord", "color"), return_grid_coord=True),
            crop=None,
            post_transform=[
                dict(type="CenterShift", apply_z=False),
                dict(type="Add", keys_dict={"condition": "S3DIS"}),
                dict(type="ToTensor"),
                dict(type="Collect", keys=("coord", "grid_coord", "index", "condition"),
                     feat_keys=("coord", "color")),
            ],
            aug_transform=[[dict(type="RandomScale", scale=[1, 1])]],
        ))


def ppt_config(work, root, batch_size, base=PPT_CONFIG, name="ppt"):
    """``base`` (a shipped S3DIS PPT config) over phase 15's scenes at
    ``batch_size``: its three train datasets on ``ppt_splits``, its val on
    the S3DIS val area, and a ``data.test`` (``ppt_test_data``), as
    ``incr_test_config`` adds one.  Returns the config's path."""
    from pointcloudpdf_tpu_torch.utils.config import Config

    data = Config.fromfile(base).to_dict()["data"]
    datasets = data["train"]["datasets"]
    for dataset, (data_root, split) in zip(datasets, ppt_splits(root, batch_size)):
        dataset.update(data_root=data_root, split=split)
    s3dis = os.path.join(root, "s3dis")
    path = os.path.join(work, f"{name}_b{batch_size}.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{base!r}]\nbatch_size = {batch_size}\n"
                f"data = dict(train=dict(datasets={datasets!r}), "
                f"val=dict(data_root={s3dis!r}), test={ppt_test_data(s3dis)!r})\n")
    return path


@contextlib.contextmanager
def recorded_ppt_steps():
    """Within: every collated batch tagged with its dataset's class
    (``source``), and each ``MultiDatasetTrainer`` step's (condition,
    source) and each evaluator forward's condition recorded."""
    from pointcloudpdf_tpu_torch.datasets import loader
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    trainer_cls = TRAINERS.get("MultiDatasetTrainer")
    prepare, run_step, eval_step = (loader.DataLoader._prepare, trainer_cls.run_step,
                                    trainer_cls.eval_step)
    seen = dict(steps=[], evals=[])

    def tagged(self, batch_idx):
        out = prepare(self, batch_idx)
        out["source"] = type(self.dataset).__name__
        return out

    def recording_step(self):
        run_step(self)
        seen["steps"].append((self.comm_info["condition"],
                              self.comm_info["input_dict"]["source"]))

    def recording_eval(self, batch):
        seen["evals"].append(batch.get("condition_name"))
        return eval_step(self, batch)

    loader.DataLoader._prepare = tagged
    trainer_cls.run_step, trainer_cls.eval_step = recording_step, recording_eval
    try:
        yield seen
    finally:
        loader.DataLoader._prepare = prepare
        trainer_cls.run_step, trainer_cls.eval_step = run_step, eval_step


def ppt_fragment_check(tester):
    """The val room's largest fragment (under ``S3DIS``): its voxel maps on
    the card equal the CPU's bit for bit, its logits under ``S3DIS`` on a
    crop of it (``CPU_CROP``) within ``TOL_SPUNET_LOGITS`` of the port's CPU
    forward, nothing dropped, and each condition's head on the card (one
    CPU forward of a crop, not three of the fragment: the script's time
    limit, since phases 16 and 17 came); its forward's ms on the card."""
    import torch

    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn

    tester.load_weights()
    fragments = tester.test_dataset[0]["fragment_list"]
    fragment = max(fragments, key=lambda f: len(f["coord"]))
    batch = tester.device_batch(padded_collate_fn([fragment]))
    expect(batch["condition_name"] == "S3DIS", "the test fragments carry S3DIS")
    print(f"  largest fragment {int(batch['mask'].sum())} points (bucket "
          f"{batch['mask'].shape[1]}) of {len(fragments)}")
    classes = check_fragment_maps(tester, fragment, batch, name="PPT", conditions=("S3DIS",),
                                  cpu_crop=CPU_CROP)
    with torch.inference_mode():
        for condition in tester.model.conditions:
            if condition not in classes:
                out = tester.forward(dict(batch, condition_name=condition))["seg_logits"]
                expect(bool(torch.isfinite(out).all()), f"finite logits under {condition}")
                classes[condition] = out.shape[-1]
    expect([classes[c] for c in tester.model.conditions] == [25, 20, 13],
           "25 / 20 / 13 classes under Structured3D / ScanNet / S3DIS")

    def forward():
        with torch.inference_mode():
            tester.forward(batch)

    return dict(ms=cuda_ms(forward, 3), points=int(batch["mask"].sum()),
                bucket=int(batch["mask"].shape[1]), fragments=len(fragments))


def ppt_step_profile(work, config):
    """One Structured3D batch of the trained config's loader: its train step
    by CUDA events (three after a warm-up), its peak memory, its
    ``indexing_backward_kernel`` share, and one step's loss under autocast
    against f32."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _profile_torch import profile_call

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    cfg = default_config_parser(config, {
        "save_path": os.path.join(work, "exp_ppt_profile"), "device": DEVICE,
        "num_worker": 4, "evaluate": False, "hooks": [], "seed": SEED})
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="MultiDatasetTrainer", cfg=cfg))
    input_dict = next(iter(trainer.train_loader))
    batch = trainer.device_batch(input_dict)
    expect(batch["condition_name"] == "Structured3D", "the epoch opens on Structured3D")
    trainer._dispatch_train(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        trainer._dispatch_train(batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_call(lambda: trainer._dispatch_train(batch), step_ms, "PPT step", top=8)
    share = prof["indexing_backward_ms"] / prof["device_busy_ms"]
    losses = {}
    for amp in (False, True):
        trainer.cfg.enable_amp = amp
        trainer._train_mode(True)
        with torch.no_grad(), trainer._amp():
            losses[amp] = float(trainer.compute_loss(
                trainer.forward_train(trainer.model, batch), batch)[0])
    print(f"  PPT train step, batch {list(batch['coord'].shape)} (valid points "
          f"{input_dict['count'].tolist()}): {step_ms:.1f} ms (CUDA events), peak "
          f"{peak:.2f} GiB; indexing_backward_kernel {prof['indexing_backward_ms']:.3f} ms, "
          f"{share:.4f} of {prof['device_busy_ms']:.1f} ms busy; one step's loss f32 "
          f"{losses[False]:.6f}, bfloat16 autocast {losses[True]:.6f}")
    expect(share <= MAX_INDEXING_BACKWARD_SHARE,
           f"indexing backward share {share:.4f} <= {MAX_INDEXING_BACKWARD_SHARE}")
    expect(np.isfinite(losses[True])
           and abs(losses[True] - losses[False]) <= TOL_AMP_LOGITS * abs(losses[False]),
           f"the autocast loss finite and within {TOL_AMP_LOGITS} of the f32 loss")
    return dict(step_ms=step_ms, peak=peak, share=share, busy_ms=prof["device_busy_ms"],
                shape=list(batch["coord"].shape), amp_loss=losses[True],
                f32_loss=losses[False])


def run_ppt_training(work, root):
    """Phase 15(a): the shipped S3DIS PPT config through the CLIs at the
    largest batch that fits, every step's condition its batch's dataset's;
    the tester on the checkpoint; the fragment and step checks."""
    import re

    import torch

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.test import TESTERS

    for batch_size in PPT_TRAIN_BATCHES:
        config = ppt_config(work, root, batch_size)
        save_path = os.path.join(work, f"exp_ppt_b{batch_size}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with recorded_ppt_steps() as seen:
                log = run_tool("train_torch.py", [
                    "--config-file", config, "--device", DEVICE, "--options",
                    f"save_path={save_path}", "num_worker=4", "epoch=1", "eval_epoch=1",
                    f"seed={SEED}"])
        except torch.cuda.OutOfMemoryError:
            print(f"  batch size {batch_size} does not fit the card's memory (tried for "
                  f"{time.perf_counter() - t0:.1f} s)")
        else:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            break
        # the failed run's tensors are free once its traceback is gone
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise SmokeFailure("no batch size fits the card's memory")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = train_log_losses(log, len(seen["steps"]))["loss"]
    print(f"  tools/train_torch.py: batch size {batch_size} (shipped 12), 1 epoch of "
          f"{len(seen['steps'])} steps (condition, source) {seen['steps']}, {wall:.1f} s, "
          f"peak {peak:.2f} GiB; losses {losses}; evaluator forwards under "
          f"{sorted(set(seen['evals']))}")
    for line in re.findall(r"Val result: [^\n]*", log):
        print("  " + line)
    expect([c for c, _ in seen["steps"]] == ["Structured3D", "Structured3D", "ScanNet",
                                             "S3DIS"],
           "one epoch at the ratios 2 : 1 : 1: Structured3D twice, ScanNet, S3DIS")
    expect(all(PPT_SOURCES[source] == c for c, source in seen["steps"]),
           "each step's condition is its batch's dataset's")
    expect(all(np.isfinite(losses)), "finite losses")
    expect("Val result: mIoU/mAcc/allAcc" in log and seen["evals"]
           and set(seen["evals"]) == {"S3DIS"}, "the evaluator ran under S3DIS")
    weight = os.path.join(save_path, "model", "model_last.pth")
    test_save = os.path.join(work, "exp_ppt_test")
    log = run_tool("test_torch.py", ["--config-file", config, "--device", DEVICE,
                                     "--options", f"weight={weight}",
                                     f"save_path={test_save}"])
    pred = np.load(glob.glob(os.path.join(test_save, "result", "*_pred.npy"))[0])
    n_val = len(np.load(os.path.join(root, "s3dis", "Area_5", "office_1.npz"))["coord"])
    expect("Val result: mIoU/mAcc/allAcc" in log and pred.shape == (n_val,)
           and pred.max() < 13, f"tools/test_torch.py tested the checkpoint under S3DIS: "
                                f"pred of {n_val} points in S3DIS's 13 classes")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = default_config_parser(config, {"weight": weight, "device": DEVICE,
                                         "save_path": os.path.join(work, "exp_ppt_frag")})
    tester = TESTERS.build(dict(type="SemSegTester", cfg=cfg))
    serving = ppt_fragment_check(tester)
    del tester
    gc.collect()
    torch.cuda.empty_cache()
    step = ppt_step_profile(work, config)
    step.update(batch_size=batch_size, train_peak=peak, train_wall=wall, serving=serving)
    return step


def run_ppt_v3_step(work, root):
    """Phase 15(b): one ``MultiDatasetTrainer`` step (a Structured3D batch)
    and one eval forward (the S3DIS val room) of the shipped S3DIS
    PPT-extreme config at the largest batch of ``PPT_V3_BATCHES`` that
    fits."""
    import torch

    from pointcloudpdf_tpu_torch.datasets import build_dataset, padded_collate_fn
    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    config = ppt_config(work, root, PPT_V3_BATCHES[0], PPT_V3_CONFIG, "ppt_v3")
    cfg = default_config_parser(config, {
        "save_path": os.path.join(work, "exp_ppt_v3"), "device": DEVICE, "num_worker": 4,
        "hooks": [], "seed": SEED})
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="MultiDatasetTrainer", cfg=cfg))
    expect(trainer.model.backbone.pd_conditions and cfg.model.backbone.enc_patch_size[0] == 1024,
           "PT-v3 with PD banks and patches of 1,024")
    structured3d = build_dataset(dict(cfg.data.train.datasets[0]))
    samples = [structured3d[i] for i in range(PPT_V3_BATCHES[0])]
    val = trainer.device_batch(next(iter(trainer.val_loader)))
    for batch_size in PPT_V3_BATCHES:
        input_dict = padded_collate_fn(samples[:batch_size], mix_prob=cfg.mix_prob,
                                       ignore_index=-1)
        trainer.comm_info["input_dict"] = input_dict
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer.run_step()
            loss = float(trainer.comm_info["model_output_dict"]["loss"])
            logits = trainer.eval_step(val)["seg_logits"]
        except torch.cuda.OutOfMemoryError:
            print(f"  PT-v3 PPT-extreme: batch {batch_size} does not fit the card's memory")
        else:
            break
        trainer.optimizer.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise SmokeFailure("no PT-v3 PPT batch fits the card's memory")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  PT-v3 PPT-extreme: a step at batch {batch_size} (shipped 24) on "
          f"{list(input_dict['coord'].shape)} under {trainer.comm_info['condition']}, loss "
          f"{loss:.4f}; eval forward on the val room {list(logits.shape)}; peak {peak:.2f} GiB")
    expect(np.isfinite(loss) and bool(torch.isfinite(logits).all())
           and logits.shape[-1] == 13, "PT-v3 PPT: finite loss, finite S3DIS logits")
    return dict(batch_size=batch_size, peak=peak, shape=list(input_dict["coord"].shape))


def run_ppt_v1m2_step(work, root):
    """Phase 15(c): the SemanticKITTI PPT-v1m2 model dict (SpUNet-v1m3 at
    full width, a head a condition) on 2 x ``CAC_POINTS`` indoor points
    under ``SemanticKITTI`` (coordinates and a strength channel, labels
    clipped to its 19 classes): one ``MultiDatasetTrainer`` step, the idle
    heads moved by AdamW's decay alone (their zero gradient), and one eval
    forward."""
    import torch

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.utils.config import Config

    outdoor = Config.fromfile(PPT_V1M2_CONFIG)
    cfg = default_config_parser(ppt_config(work, root, 2), {
        "save_path": os.path.join(work, "exp_ppt_v1m2"), "device": DEVICE, "num_worker": 0,
        "hooks": [], "seed": SEED, "evaluate": False, "batch_size": 2})
    cfg.model, cfg.optimizer, cfg.scheduler = (outdoor.model, outdoor.optimizer,
                                               outdoor.scheduler)
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type="MultiDatasetTrainer", cfg=cfg))
    rng = np.random.RandomState(SEED + 5)
    paths = sorted(glob.glob(os.path.join(root, "s3dis", "rooms", "*.npz")))[:2]
    out = {k: [] for k in ("coord", "grid_coord", "feat", "segment")}
    for path in paths:
        room = np.load(path)
        grid = np.floor((room["coord"] - room["coord"].min(0)) / 0.05).astype(np.int32)
        first = np.unique(grid, axis=0, return_index=True)[1]
        keep = first[rng.permutation(len(first))[:CAC_POINTS]]
        coord = room["coord"][keep]
        strength = room["color"][keep].mean(1, keepdims=True) / 255.0
        values = dict(coord=coord, grid_coord=grid[keep],
                      feat=np.concatenate([coord - coord.mean(0), strength], 1),
                      segment=np.minimum(room["semantic_gt"][keep], 18))
        for k in out:
            pad = [(0, CAC_BUCKET - len(coord))] + [(0, 0)] * (values[k].ndim - 1)
            out[k].append(np.pad(values[k], pad, constant_values=-1 if k == "segment" else 0))
    input_dict = {k: np.stack(v) for k, v in out.items()}
    input_dict.update(coord=input_dict["coord"].astype(np.float32),
                      feat=input_dict["feat"].astype(np.float32),
                      segment=input_dict["segment"].astype(np.int64),
                      count=np.full(2, CAC_POINTS, np.int32), condition=["SemanticKITTI"] * 2)
    heads = trainer.model.seg_heads
    idle = {n: p.detach().clone() for i in (1, 2) for n, p in heads[i].named_parameters(
        prefix=f"seg_heads.{i}")}
    trainer.comm_info["input_dict"] = input_dict
    trainer.run_step()
    loss = float(trainer.comm_info["model_output_dict"]["loss"])
    params = dict(trainer.model.named_parameters())
    group = next(g for g in trainer.optimizer.param_groups
                 if any(p is params["seg_heads.1.weight"] for p in g["params"]))
    decay = 1 - group["lr"] * group["weight_decay"]
    gaps = {n: float((params[n].detach() - old * decay).abs().max()) for n, old in idle.items()}
    moved = all(not torch.equal(params[n].detach(), old) for n, old in idle.items()
                if old.abs().max() > 0)
    logits = trainer.eval_step(trainer.device_batch(input_dict))["seg_logits"]
    print(f"  PPT-v1m2 (SemanticKITTI model dict): step on {list(input_dict['coord'].shape)} "
          f"loss {loss:.4f}; idle heads against p (1 - lr wd), lr {group['lr']:.3e}, wd "
          f"{group['weight_decay']}: {gaps}; eval logits {list(logits.shape)}")
    expect(np.isfinite(loss) and bool(torch.isfinite(logits).all())
           and logits.shape[-1] == 19, "PPT-v1m2: finite loss, 19 SemanticKITTI classes")
    expect(moved and max(gaps.values()) <= 1e-6,
           "PPT-v1m2's idle heads moved by AdamW's decay alone")


def run_ppt_slice(work):
    """Phase 15: (a) training, evaluating and testing the shipped S3DIS PPT
    config, (b) a PT-v3 PPT-extreme step, (c) a PPT-v1m2 step; no K1-K7
    launch anywhere (asserted)."""
    import torch

    reset_launches()
    t0 = time.perf_counter()
    root = ppt_rooms(work)
    walls = {"rooms": time.perf_counter() - t0}
    print("  (a) tools/train_torch.py, the evaluator and tools/test_torch.py on the "
          "shipped S3DIS PPT config at full width")
    t0 = time.perf_counter()
    step = run_ppt_training(work, root)
    walls["a"] = time.perf_counter() - t0
    print("  (b) the shipped S3DIS PT-v3 PPT-extreme config: a step and an eval forward")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    step["v3"] = run_ppt_v3_step(work, root)
    walls["b"] = time.perf_counter() - t0
    print("  (c) PPT-v1m2 over SpUNet-v1m3 (the SemanticKITTI model dict): a step and an "
          "eval forward")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    run_ppt_v1m2_step(work, root)
    walls["c"] = time.perf_counter() - t0
    no_kernel_launched(read_launches(), "Point Prompt Training (phase 15)")
    print("  phase 15 walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return step


# ---------------------------------------------------------------------------
# phase 16: the window-attention backbones.  Swin3D's kNN pooling and
# interpolation launch K1; its cRSE attention and OctFormer are plain
# PyTorch (no Pallas kernel sits under either in the JAX package)

SWIN3D_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-swin3d-v1m1-0-small.py")
OCTFORMER_CONFIG = os.path.join(ROOT, "configs", "scannet",
                                "semseg-octformer-v1m1-0-base.py")
WINDOW_TRAIN_BATCHES = PTV2_TRAIN_BATCHES  # the shipped 12, its halves, 2 and 1
# Swin3D's 12 and 6 and OctFormer's 12 do not fit one H100 80GB (PERF.md):
# their training starts at the batch that fits, for the time limit
SWIN3D_TRAIN_BATCHES, OCTFORMER_TRAIN_BATCHES = (3, 2, 1), (6, 3, 2, 1)
# launches of one Swin3D forward (five layers): K1 once a downsample and once
# an interpolation
SWIN3D_PER_FORWARD = {"knn": 4 + 4}
# a fragment's logits, card against CPU, of max |logit|: f32 on both (TF32
# off), the same kNN sets, 23 (Swin3D) or 24 (OctFormer) attention blocks
# summed in other orders
TOL_WINDOW_LOGITS = 1e-4
# the share of a fragment the CPU forward takes (a spatial crop: the full
# fragment's CPU forward at full width would take minutes)
CPU_CROP = 0.1


def crop_fragment(fragment, share):
    """The points of a test fragment (a dict of per-point arrays) below the
    ``share`` quantile of x: a fragment of its own, smaller."""
    x = fragment["coord"][:, 0]
    keep = x <= np.quantile(x, share)
    n = len(x)
    return {k: v[keep] if isinstance(v, np.ndarray) and len(v) == n else v
            for k, v in fragment.items()}


def window_levels(model, batch):
    """Each level's valid rows (the batch's largest count) and held rows."""
    import torch

    backbone = model.backbone
    with torch.inference_mode():
        if hasattr(backbone, "levels"):
            masks = [lv.mask for lv in backbone.levels(batch)]
        else:
            masks = backbone.index_maps(batch["grid_coord"], batch["mask"])["mask"]
    return dict(valid_rows=[int(m.sum(1).max()) for m in masks],
                held_rows=[int(m.shape[1]) for m in masks])


def window_fragment_check(tester, fragment, batch):
    """A Swin3D or OctFormer test fragment: its levels' valid and held rows,
    the card's logits within ``TOL_WINDOW_LOGITS`` of the port's CPU forward
    on a crop of it (``CPU_CROP``), its forward timed and profiled."""
    import copy

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _profile_torch import profile_call

    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn

    levels = window_levels(tester.model, batch)
    print(f"  levels: valid rows {levels['valid_rows']}, held {levels['held_rows']}")
    crop = tester.device_batch(padded_collate_fn([crop_fragment(fragment, CPU_CROP)]))
    cpu_model = copy.deepcopy(tester.model).cpu()
    cpu_batch = {k: v.cpu() if torch.is_tensor(v) else v for k, v in crop.items()}
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = tester.forward(crop)["seg_logits"].cpu()
        cpu = cpu_model(cpu_batch)["seg_logits"]
    lmax, lerr = float(cpu.abs().max()), float((out - cpu).abs().max())
    print(f"  crop of {int(crop['mask'].sum())} points, card against CPU: logits err "
          f"{lerr:.3e} (max |logit| {lmax:.3e}; {time.perf_counter() - t0:.1f} s)")
    expect(lerr <= TOL_WINDOW_LOGITS * lmax,
           f"logits on the card within {TOL_WINDOW_LOGITS} x max |logit| of the CPU's")
    del cpu_model

    def forward():
        with torch.inference_mode():
            tester.forward(batch)

    ms = cuda_ms(forward, 3)
    prof = profile_call(forward, ms, "fragment forward", top=8)
    window_fragment_check.result = dict(
        ms=ms, points=int(batch["mask"].sum()), bucket=int(batch["mask"].shape[1]),
        busy_ms=prof["device_busy_ms"], idle=prof["idle_share_unprofiled"],
        cpu_err=lerr / lmax, **levels)


def octformer_config(work):
    """The shipped ScanNet OctFormer config with ``project_displacement=True``
    on its three ``GridSample``s: as shipped they return a 3-wide
    displacement, so the features (colour, normal, coordinates,
    displacement) are 12 wide for a model of ``in_channels=10``, in both
    packages (ROADMAP §3); projected on the normal it is 1 wide.  Returns
    the derived config's path."""
    from pointcloudpdf_tpu_torch.utils.config import Config

    data = Config.fromfile(OCTFORMER_CONFIG).to_dict()["data"]
    samples = [t for t in (*data["train"]["transform"], *data["val"]["transform"],
                           data["test"]["test_cfg"]["voxelize"]) if t["type"] == "GridSample"]
    expect(len(samples) == 3 and all(t.get("return_displacement") for t in samples),
           "the OctFormer config's three GridSamples return the displacement")
    for t in samples:
        t["project_displacement"] = True
    path = os.path.join(work, "octformer_projected.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{OCTFORMER_CONFIG!r}]\n"
                f"data = dict(train=dict(transform={data['train']['transform']!r}), "
                f"val=dict(transform={data['val']['transform']!r}), "
                f"test=dict(test_cfg=dict(voxelize={data['test']['test_cfg']['voxelize']!r})))\n")
    return path


def scannet_layout(work, normals_root):
    """Phase 14's rooms (with normals) relabelled into ScanNet's 20 classes
    under ``work/scannet_oct``: train splits ``Batch{b}`` of 2 b scenes
    (links over the train rooms) and the val room as ``val``.  Returns the
    root and the val room's points (made once a run)."""
    root = os.path.join(work, "scannet_oct")
    if os.path.isdir(root):
        return root, len(np.load(os.path.join(root, "val", "scene0000_00.npz"))["coord"])
    rooms = sorted(glob.glob(os.path.join(normals_root, "Area_[1-46]", "*.npz")))
    os.makedirs(os.path.join(root, "rooms"))
    os.makedirs(os.path.join(root, "val"))
    for i, path in enumerate([*rooms, os.path.join(normals_root, "Area_5", "office_1.npz")]):
        room = dict(np.load(path))
        label = room.pop("semantic_gt")
        name = (os.path.join("rooms", f"{i}.npz") if i < len(rooms)
                else os.path.join("val", "scene0000_00.npz"))
        np.savez(os.path.join(root, name), semantic_gt20=S3DIS_TO_SCANNET[label], **room)
    for b in WINDOW_TRAIN_BATCHES:
        split = os.path.join(root, f"Batch{b}")
        os.makedirs(split)
        for j in range(2 * b):
            os.symlink(os.path.join(root, "rooms", f"{j % len(rooms)}.npz"),
                       os.path.join(split, f"scene{j:04d}_00.npz"))
    return root, len(room["coord"])


def serve_scannet_layout(work, config, root, n_val, name="octformer",
                         fragment_check=window_fragment_check):
    """``tools/test_torch.py`` on a ScanNet config over ``scannet_layout``'s
    val scene, seeded random weights through the bridge; no kernel
    launched; ``fragment_check`` on the largest fragment (phase 16(c): the
    OctFormer config, ``octformer_config``; phase 17(c): OA-CNNs)."""
    import torch

    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn
    from pointcloudpdf_tpu_torch.engines.test import TESTERS
    from pointcloudpdf_tpu_torch.models import build_model
    from pointcloudpdf_tpu_torch.utils.config import Config

    cfg = Config.fromfile(config)
    torch.manual_seed(SEED)
    weight = os.path.join(work, f"model_{name}.pth")
    random_jax_checkpoint(weight, build_model(dict(cfg.model)))
    save_path = os.path.join(work, f"exp_{name}")
    reset_launches()
    t0 = time.perf_counter()
    log = run_tool("test_torch.py", [
        "--config-file", config, "--device", DEVICE, "--options",
        f"data_root={root}", f"weight={weight}", f"save_path={save_path}",
        f"data.test.data_root={root}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel_launched(read_launches(), f"{name} serving")
    forwards = log.count(", Batch: ")
    pred = np.load(glob.glob(os.path.join(save_path, "result", "*_pred.npy"))[0])
    expect("Val result: mIoU/mAcc/allAcc" in log and pred.shape == (n_val,)
           and pred.min() >= 0 and pred.max() < 20,
           f"pred covers all {n_val} points, in [0, 20)")
    cfg.merge_from_dict({"data_root": root, "weight": weight, "device": DEVICE,
                         "save_path": os.path.join(work, f"exp_{name}_check"),
                         "data.test.data_root": root})
    tester = TESTERS.build(dict(type="SemSegTester", cfg=cfg))
    tester.load_weights()
    fragments = tester.test_dataset[0]["fragment_list"]
    fragment = max(fragments, key=lambda f: len(f["coord"]))
    print(f"  tools/test_torch.py: {wall:.1f} s, {forwards} forwards; {len(fragments)} "
          f"fragments of up to {len(fragment['coord'])} points")
    reset_launches()
    fragment_check(tester, fragment, tester.device_batch(padded_collate_fn([fragment])))
    no_kernel_launched(read_launches(), f"{name}'s fragment check")
    return dict(fragment_check.result, fragments=len(fragments), wall=wall)


def train_window_model(work, config, name, data_root, test_root,
                       sizes=WINDOW_TRAIN_BATCHES):
    """``tools/train_torch.py`` on ``config`` at full width at the largest
    batch of ``sizes`` that fits (one epoch of two steps and
    the evaluator; autocast, Mix3D and drop path as shipped), then one
    batch's step profiled with its levels' rows, at that batch size or,
    where its batch does not fit (Mix3D and the crops draw the memory
    anew: OA-CNNs' 6 fitted a training run once and not its profiled
    batch), the next that fits.  Returns (launches, step); the step's
    ``save_path`` is the training run's, its ``batch_size`` the profiled
    one, ``train_batch_size`` the run's."""
    import re

    import torch

    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, config, name, data_root, 1, [f"data.test.data_root={test_root}"],
        subsample=False, sizes=sizes, areas=lambda b: (f"Batch{b}",))
    losses = train_log_losses(log, iters)["loss"]
    print(f"  losses {losses}")
    for line in re.findall(r"Val result: [^\n]*", log):
        print("  " + line)
    expect(all(np.isfinite(losses)), "finite losses")
    expect("Val result: mIoU/mAcc/allAcc" in log, "the evaluator ran")
    gc.collect()
    torch.cuda.empty_cache()
    for size in [b for b in sizes if b <= batch_size]:
        try:
            step = profile_train_step(work, data_root, size, config, name, report=window_levels)
        except torch.cuda.OutOfMemoryError:
            print(f"  {name}: the profiled batch of {size} does not fit the card's memory")
        else:
            break
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise SmokeFailure(f"{name}: no profiled batch fits the card's memory")
    print(f"  {name} step levels: valid rows {step['valid_rows']}, held {step['held_rows']}")
    step.update(batch_size=size, train_batch_size=batch_size, train_peak=peak, train_wall=wall,
                save_path=save_path)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, step


def run_window_slice(work):
    """Phase 16: (a) serving and (b) training the shipped S3DIS Swin3D-small
    config, (c) serving and (d) training the shipped ScanNet OctFormer
    config, over phase 14's rooms (made here when phase 14 has not run)."""
    import torch

    walls = {}
    t0 = time.perf_counter()
    normals_root = os.path.join(work, "s3dis_train_ptv3")
    if os.path.isdir(normals_root):
        n_val = int(len(np.load(os.path.join(normals_root, "Area_5", "office_1.npz"))["coord"]))
    else:
        normals_root, n_val = make_train_rooms(work, "s3dis_train_ptv3", **PTV3_ROOM)
    split_root = two_batch_splits(work, normals_root, "s3dis_two_batches_normals")
    scannet_root, n_scannet = scannet_layout(work, normals_root)
    walls["rooms"] = time.perf_counter() - t0

    print("  (a) tools/test_torch.py on the shipped S3DIS Swin3D-small config")
    t0 = time.perf_counter()
    serving = run_slice(work, SWIN3D_CONFIG, "swin3d", SWIN3D_PER_FORWARD,
                        fragment_check=window_fragment_check, room=PTV3_ROOM)
    swin_fragment = window_fragment_check.result
    expect(serving["knn"] > 0, f"K1 launched {serving['knn']} times serving Swin3D")
    walls["a"] = time.perf_counter() - t0

    print("  (b) tools/train_torch.py on it at full width (phase 14's rooms)")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, swin_step = train_window_model(
        work, SWIN3D_CONFIG, "Swin3D", split_root, normals_root, SWIN3D_TRAIN_BATCHES)
    n_train = sum(train_launches[k] for k in ("knn_pruned", "knn_brute"))
    expect(n_train > 0, f"K1 launched {n_train} times training Swin3D")
    for key, n in train_launches.items():
        if key not in ("knn", "knn_pruned", "knn_brute", "gva_by_width"):
            expect(not (sum(n) if isinstance(n, tuple) else n),
                   f"Swin3D training launched no {key} kernel")
    walls["b"] = time.perf_counter() - t0

    print("  (c) tools/test_torch.py on the shipped ScanNet OctFormer config, its "
          "displacement projected on the normal")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    oct_config = octformer_config(work)
    oct_serving = serve_scannet_layout(work, oct_config, scannet_root, n_scannet)
    walls["c"] = time.perf_counter() - t0

    print("  (d) tools/train_torch.py on it at full width (ScanNet's layout)")
    t0 = time.perf_counter()
    oct_launches, oct_step = train_window_model(
        work, oct_config, "OctFormer", scannet_root, scannet_root, OCTFORMER_TRAIN_BATCHES)
    no_kernel_launched(oct_launches, "OctFormer training and its evaluator")
    walls["d"] = time.perf_counter() - t0
    print("  phase 16 walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return (serving, {k: train_launches[k] for k in ("knn_pruned", "knn_brute")},
            dict(swin3d=dict(swin_step, serving=swin_fragment),
                 octformer=dict(oct_step, serving=oct_serving)))


# ---------------------------------------------------------------------------
# phase 17: instance segmentation (PointGroup over SpUNet and over PPT, the
# host clustering, InsSegEvaluator) and OA-CNNs.  No kernel of their own:
# plain PyTorch over phase 13's rulebook conv, as the JAX package's are plain
# jnp; the clustering and the AP run on the card's host, as the JAX package
# runs them on its host.

PG_CONFIG = os.path.join(ROOT, "configs", "s3dis", "insseg-pointgroup-v1m1-0-spunet-base.py")
# (name, config, the batch's condition)
PG_OTHER_CONFIGS = (
    ("ScanNet PointGroup", os.path.join(ROOT, "configs", "scannet",
                                        "insseg-pointgroup-v1m1-0-spunet-base.py"), None),
    ("ScanNet200 PointGroup", os.path.join(ROOT, "configs", "scannet200",
                                           "insseg-pointgroup-spunet-0-base.py"), None),
    ("S3DIS PPT fine-tune PointGroup", os.path.join(
        ROOT, "configs", "s3dis", "insseg-ppt-v1m1-0-pointgroup-spunet-ft.py"), "S3DIS"),
)
PG_LOSS_KEYS = ("loss", "seg_loss", "bias_l1_loss", "bias_cosine_loss")
OACNNS_CONFIG = os.path.join(ROOT, "configs", "scannet", "semseg-oacnns-v1m1-0-base.py")
INSSEG_TRAIN_BATCHES = PTV2_TRAIN_BATCHES  # the shipped 12, its halves, 2 and 1


def insseg_grid_batch(trainer, data_root, grid, condition=None, rooms=2):
    """``CAC_POINTS`` voxels of each of two of phase 14's rooms at ``grid``
    (the first point of a voxel): coordinates, grid, colour and normal,
    labels clipped to ScanNet's 20 classes, the rooms' instances and their
    centroids over the kept points; tagged ``condition`` where given."""
    rng = np.random.RandomState(SEED + 4)
    paths = sorted(glob.glob(os.path.join(data_root, TRAIN_AREAS[0], "*.npz")))[:rooms]
    keys = ("coord", "grid_coord", "feat", "segment", "instance", "instance_centroid")
    out = {k: [] for k in keys}
    for path in paths:
        room = np.load(path)
        cells = np.floor((room["coord"] - room["coord"].min(0)) / grid).astype(np.int32)
        first = np.unique(cells, axis=0, return_index=True)[1]
        keep = first[rng.permutation(len(first))[:CAC_POINTS]]
        coord, instance = room["coord"][keep], room["instance_gt"][keep]
        centroid = np.zeros_like(coord)
        for iid in np.unique(instance):
            centroid[instance == iid] = coord[instance == iid].mean(0)
        values = dict(coord=coord, grid_coord=cells[keep], feat=np.concatenate(
            [room["color"][keep] / 255.0, room["normal"][keep]], 1),
            segment=np.minimum(room["semantic_gt"][keep], 19), instance=instance,
            instance_centroid=centroid)
        for k in keys:
            pad = [(0, CAC_BUCKET - len(coord))] + [(0, 0)] * (values[k].ndim - 1)
            fill = -1 if k in ("segment", "instance") else 0
            out[k].append(np.pad(values[k], pad, constant_values=fill))
    batch = {k: np.stack(v) for k, v in out.items()}
    for k in ("coord", "feat", "instance_centroid"):
        batch[k] = batch[k].astype(np.float32)
    for k in ("segment", "instance"):
        batch[k] = batch[k].astype(np.int64)
    batch["count"] = np.full(rooms, CAC_POINTS, np.int32)
    if condition is not None:
        batch["condition"] = [condition] * rooms
    return trainer.device_batch(batch)


def config_grid(config):
    """The grid of a config's training ``GridSample``."""
    from pointcloudpdf_tpu_torch.utils.config import Config

    return next(t["grid_size"] for t in Config.fromfile(config).data.train.transform
                if t["type"] == "GridSample")


def pointgroup_step(work, name, config, data_root, condition):
    """Phase 17(b): one ``DefaultTrainer`` step and one eval forward of a
    PointGroup config at full width on 2 x 8,000 points at its grid (the
    model's loss and three parts, no kernel launched), then ``propose`` on
    the first sample.  Returns the peak GiB."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    grid = config_grid(config)
    trainer, batch, out, _ = one_step_and_eval(
        config, work, name, {}, lambda t: insseg_grid_batch(t, data_root, grid, condition))
    expect(set(out) == set(PG_LOSS_KEYS), f"{name}: the model's loss and its three parts")
    if condition is not None:
        expect(batch["condition_name"] == condition, f"{name}: the batch's condition reached "
                                                     "the model")
    evaluated = trainer.eval_step(batch)
    n = CAC_POINTS
    t0 = time.perf_counter()
    masks, classes, _ = trainer.model.propose(*(
        t[0, :n].float().cpu().numpy() for t in (batch["coord"], evaluated["seg_logits"],
                                                 evaluated["bias_pred"])), np.ones(n, bool))
    ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {name}: grid {grid} m, {len(classes)} proposals from {n} points in {ms:.1f} ms "
          f"on the host; peak {peak:.2f} GiB")
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def pointgroup_checks(work, data_root, weight):
    """Phase 17(a), after training: the shipped hook (``InsSegEvaluator``)
    over the val area on the trained checkpoint, its forwards on the card;
    its AP table against the host functions recomputed on the outputs it
    was given (bit for bit); the largest val scene's ``seg_logits`` and
    ``bias_pred`` against the port's CPU forward (``TOL_SPUNET_LOGITS``).
    Returns the proposals and the clustering's ms a scene and the metrics."""
    import copy

    import torch

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.hooks import build_hooks
    from pointcloudpdf_tpu_torch.engines.hooks.evaluator import ap_summary, ap_table
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.utils.checkpoint import load_checkpoint
    from pointcloudpdf_tpu_torch.utils.config import Config

    shipped = [h for h in Config.fromfile(PG_CONFIG).hooks if h["type"] == "InsSegEvaluator"]
    cfg = default_config_parser(PG_CONFIG, {
        "data_root": data_root, "data.train.data_root": data_root,
        "data.train.split": ("Batch1",), "data.val.data_root": data_root,
        "save_path": os.path.join(work, "exp_pointgroup_check"), "device": DEVICE,
        "batch_size": 1, "num_worker": 0, "hooks": [], "seed": SEED})
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=cfg))
    trainer.load_state_dict(load_checkpoint(weight)["state"])
    hook, = build_hooks(shipped)
    hook.trainer = trainer
    hook.before_train()
    recorded = []
    host_scenes = hook.batch_scenes

    def recording(model, input_dict, out):
        recorded.append((input_dict, {k: v.clone() for k, v in out.items()}))
        return host_scenes(model, input_dict, out)

    hook.batch_scenes = recording
    reset_launches()
    hook.eval()
    no_kernel_launched(read_launches(), "the evaluator's forwards")
    scenes = [s for input_dict, out in recorded
              for s in host_scenes(trainer.model, input_dict, out)]
    again = ap_table(scenes, hook.valid_classes)
    m_ap, m_ap50, m_ap25 = ap_summary(hook.ap_table)
    proposals = [len(s["classes"]) for s in scenes]
    propose_ms = [s["propose_ms"] for s in scenes]
    print(f"  InsSegEvaluator on the card's outputs: mAP {m_ap:.4f}, AP50 {m_ap50:.4f}, "
          f"AP25 {m_ap25:.4f} over classes {hook.valid_classes}; proposals a scene "
          f"{proposals}, clustering {[round(t, 1) for t in propose_ms]} ms a scene "
          f"(recomputed)")
    expect(np.array_equal(hook.ap_table, again, equal_nan=True),
           "the evaluator's AP table equals the host functions' on its outputs, bit for bit")
    input_dict, out = max(recorded, key=lambda r: int(np.max(r[0]["count"])))
    batch = trainer.device_batch(input_dict)
    cpu_model = copy.deepcopy(trainer.model).cpu().eval()
    with torch.inference_mode():
        ref = cpu_model({k: v.cpu() if torch.is_tensor(v) else v for k, v in batch.items()})
    for key in ("seg_logits", "bias_pred"):
        top = float(ref[key].abs().max())
        err = float((out[key].cpu() - ref[key]).abs().max())
        print(f"  largest val scene ({int(np.max(input_dict['count']))} points): {key} card "
              f"against CPU err {err:.3e} (max {top:.3e})")
        expect(err <= TOL_SPUNET_LOGITS * top,
               f"{key} on the card within {TOL_SPUNET_LOGITS} x max of the CPU's")
    del trainer, cpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(proposals=proposals, propose_ms=propose_ms, m_ap=m_ap, m_ap50=m_ap50,
                m_ap25=m_ap25)


def oacnns_fragment_check(tester, fragment, batch):
    """An OA-CNNs test fragment: its voxel maps (every level's grid and
    mask, the parent maps, each grid size's cluster maps) built on the card
    equal the CPU's bit for bit; then ``window_fragment_check`` (levels,
    the logits on a crop against the CPU forward, the forward timed)."""
    import torch

    backbone = tester.model.backbone
    with torch.inference_mode():
        maps = backbone.index_maps(batch["grid_coord"], batch["mask"])
        ref = backbone.index_maps(batch["grid_coord"].cpu(), batch["mask"].cpu())
    compared = [(f"{key}[{i}]", a, b) for key in ("grid", "mask", "c2p")
                for i, (a, b) in enumerate(zip(maps[key], ref[key]))]
    compared += [(f"clusters[{i}][{j}]", a, b) for i, (sa, sb) in enumerate(
        zip(maps["clusters"], ref["clusters"])) for j, (a, b) in enumerate(zip(sa, sb))]
    differ = [label for label, a, b in compared if not torch.equal(a.cpu(), b)]
    expect(not differ, f"{len(compared)} OA-CNNs voxel and cluster maps equal on the card "
                       f"and the CPU bit for bit; differ: {differ}")
    window_fragment_check(tester, fragment, batch)
    oacnns_fragment_check.result = window_fragment_check.result


def run_insseg_slice(work):
    """Phase 17: (a) training and evaluating the shipped S3DIS PointGroup
    config, (b) a step of the ScanNet, ScanNet200 and S3DIS PPT fine-tune
    PointGroup configs, (c) serving and (d) training the shipped ScanNet
    OA-CNNs config, over phase 14's rooms (made here when phase 14 has not
    run; each plane and box an instance)."""
    import re

    import torch

    walls = {}
    t0 = time.perf_counter()
    normals_root = os.path.join(work, "s3dis_train_ptv3")
    if not os.path.isdir(normals_root):
        normals_root, _ = make_train_rooms(work, "s3dis_train_ptv3", **PTV3_ROOM)
    split_root = two_batch_splits(work, normals_root, "s3dis_two_batches_normals")
    scannet_root, n_scannet = scannet_layout(work, normals_root)
    walls["rooms"] = time.perf_counter() - t0

    print("  (a) tools/train_torch.py on the shipped S3DIS PointGroup config at full width, "
          "InsSegEvaluator")
    t0 = time.perf_counter()
    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, PG_CONFIG, "pointgroup_train", split_root, 1, [], subsample=False,
        sizes=INSSEG_TRAIN_BATCHES, areas=lambda b: (f"Batch{b}",))
    no_kernel_launched(launches, "PointGroup training and its evaluator")
    losses = train_log_losses(log, iters, PG_LOSS_KEYS)
    print(f"  losses {losses}")
    for line in re.findall(r"(?:Val result|Test: \[)[^\n]*", log):
        print("  " + line)
    expect("Val result: mAP/AP50/AP25" in log, "the evaluator ran: mAP, AP50 and AP25")
    gc.collect()
    torch.cuda.empty_cache()
    pg = pointgroup_checks(work, split_root, os.path.join(save_path, "model", "model_last.pth"))
    reset_launches()
    step = profile_train_step(work, split_root, batch_size, PG_CONFIG, "PointGroup")
    no_kernel_launched(read_launches(), "the profiled PointGroup steps")
    pg.update(step, batch_size=batch_size, train_peak=peak, train_wall=wall)
    gc.collect()
    torch.cuda.empty_cache()
    walls["a"] = time.perf_counter() - t0

    print("  (b) the ScanNet, ScanNet200 and S3DIS PPT fine-tune PointGroup configs: a step, "
          "an eval forward and proposals")
    t0 = time.perf_counter()
    pg["other_peaks"] = {name: pointgroup_step(work, name, config, normals_root, condition)
                         for name, config, condition in PG_OTHER_CONFIGS}
    walls["b"] = time.perf_counter() - t0

    print("  (c) tools/test_torch.py on the shipped ScanNet OA-CNNs config")
    t0 = time.perf_counter()
    oa_serving = serve_scannet_layout(work, OACNNS_CONFIG, scannet_root, n_scannet, "oacnns",
                                      oacnns_fragment_check)
    walls["c"] = time.perf_counter() - t0

    print("  (d) tools/train_torch.py on it at full width (ScanNet's layout), then the tester")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    oa_launches, oa_step = train_window_model(work, OACNNS_CONFIG, "OA-CNNs", scannet_root,
                                              scannet_root)
    no_kernel_launched(oa_launches, "OA-CNNs training and its evaluator")
    test_save = os.path.join(work, "exp_oacnns_train_test")
    reset_launches()
    log = run_tool("test_torch.py", [
        "--config-file", OACNNS_CONFIG, "--device", DEVICE, "--options",
        f"data_root={scannet_root}", f"data.test.data_root={scannet_root}",
        f"weight={os.path.join(oa_step['save_path'], 'model', 'model_last.pth')}",
        f"save_path={test_save}"])
    no_kernel_launched(read_launches(), "the tester on the trained OA-CNNs checkpoint")
    pred = np.load(glob.glob(os.path.join(test_save, "result", "*_pred.npy"))[0])
    expect("Val result: mIoU/mAcc/allAcc" in log and pred.shape == (n_scannet,),
           f"tools/test_torch.py tested the trainer's checkpoint: pred of {n_scannet} points")
    walls["d"] = time.perf_counter() - t0
    print("  phase 17 walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return pg, dict(oa_step, serving=oa_serving)


# ---------------------------------------------------------------------------
# phase 18: outdoor LiDAR (SemanticKITTI, nuScenes, Waymo).  K1 and K7 run in
# PT-v2m2's eval forward on a scan; SpUNet, MinkUNet34C, PT-v3 and PPT are
# phases 13-15's plain PyTorch, at the port's keys of 20 bits an axis

SK_DIR = os.path.join(ROOT, "configs", "semantic_kitti")
SK_PTV2_CONFIG = os.path.join(SK_DIR, "semseg-pt-v2m2-0-base.py")
SK_SUBMIT_CONFIG = os.path.join(SK_DIR, "semseg-pt-v2m2-1-benchmark-submit.py")
SK_SPUNET_CONFIG = os.path.join(SK_DIR, "semseg-spunet-v1m1-0-base.py")
SK_MINK_CONFIG = os.path.join(SK_DIR, "semseg-minkunet34c-0-base.py")
SK_PTV3_CONFIG = os.path.join(SK_DIR, "semseg-pt-v3m1-0-base.py")
SK_PPT_CONFIG = os.path.join(SK_DIR, "semseg-ppt-v1m1-0-sk-nu-wa-spunet.py")
NU_SPUNET_CONFIG = os.path.join(ROOT, "configs", "nuscenes", "semseg-spunet-v1m1-0-base.py")
WAYMO_SPUNET_CONFIG = os.path.join(ROOT, "configs", "waymo", "semseg-spunet-v1m1-0-base.py")
# each dataset's spinning LiDAR: beams and their elevations (degrees, top to
# bottom), the sensor's height (m), azimuth steps a turn (SemanticKITTI's
# HDL-64E 120,000 points a scan, nuScenes' HDL-32E 35,008, Waymo's top
# LiDAR 169,984), the half side (m) of the square of walls that every ray
# meets (inside the configs' PointClip, which clamps coordinates: a point
# past it would land on the clip's faces; nuScenes' at 60 m and Waymo's at
# 74 m, 2,400 and 2,960 cells at 5 cm, past the JAX keys' 2,048) and the
# train classes
LIDARS = {
    "SemanticKITTI": dict(beams=64, elevation=(2.0, -24.8), height=1.73, steps=1875,
                          walls=34.0, classes=19),
    "nuScenes": dict(beams=32, elevation=(10.0, -30.0), height=1.84, steps=1094,
                     walls=60.0, classes=16),
    "Waymo": dict(beams=64, elevation=(2.4, -17.6), height=2.1, steps=2656,
                  walls=74.0, classes=22),
}
# PT-v2m2's launches a forward on the SemanticKITTI config (patch embedding
# 1 block, encoder 2 + 2 + 6 + 2, decoder 1 + 1 + 1 + 1): K7 once a block, K1
# once a level (the patch level and four pooled ones)
SK_PTV2_PER_FORWARD = {"gva": 1 + (2 + 2 + 6 + 2) + (1 + 1 + 1 + 1), "knn": 5}
# ... K7's by width: 48 the patch embedding and decoder 0, then a stage and
# the decoder above it; 512 stage 4 (64 groups)
SK_PTV2_K7_BY_WIDTH = {48: 1 + 1, 96: 2 + 1, 192: 2 + 1, 384: 6 + 1, 512: 2}
SK_TRAIN_SCANS = 2     # distinct SemanticKITTI train scans ...
SK_TRAIN_LINKS = 24    # ... linked into this many frames: two batches of the shipped 12
OUTDOOR_STEP_BATCH = 2  # phase 18(d)'s steps (else 1, where 2 does not fit)
WAYMO_BAND = 0.5       # m either side of the sensor's y: phase 18(c)'s CPU crop


def lidar_scene(rng, lidar):
    """Boxes (x0, y0, z0, x1, y1, z1) and vertical poles (x, y, radius,
    top) around a sensor at the origin, over a ground plane at -height, each
    with a train class: a square of walls at the half side ``walls`` (high
    enough for the top beam at the corners), 30 boxes (cars, blocks) and 20
    poles and trunks inside it; the ground cut into one azimuth sector a
    class, so that every class is hit."""
    h, w, n_cls = lidar["height"], lidar["walls"], lidar["classes"]
    top = h + 2 ** 0.5 * w * np.tan(np.deg2rad(lidar["elevation"][0])) + 3.0
    boxes = []
    for e in np.linspace(-w, w, 5)[:-1]:
        f = e + w / 2
        boxes += [(e, w, -h, f, w + 1, top), (e, -w - 1, -h, f, -w, top),
                  (w, e, -h, w + 1, f, top), (-w - 1, e, -h, -w, f, top)]
    n = 30
    r, a = rng.uniform(5.0, 0.8 * w, n), rng.uniform(0, 2 * np.pi, n)
    size = rng.uniform((1.5, 1.5, 1.2), (4.5, 2.5, 3.5), (n, 3))
    centre = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    boxes += [(cx - sx / 2, cy - sy / 2, -h, cx + sx / 2, cy + sy / 2, -h + sz)
              for (cx, cy), (sx, sy, sz) in zip(centre, size)]
    m = 20
    r, a = rng.uniform(4.0, 0.8 * w, m), rng.uniform(0, 2 * np.pi, m)
    poles = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(0.08, 0.4, m),
                      -h + rng.uniform(3.0, 8.0, m)], 1)
    boxes = np.asarray(boxes, np.float64)
    return dict(boxes=boxes, poles=poles, height=h,
                ground=rng.permutation(n_cls),
                classes=rng.randint(0, n_cls, len(boxes) + len(poles)))


def cast_rays(dirs, scene, chunk=1 << 15):
    """Unit directions (R, 3) from the sensor -> (range (R,), what each ray
    met first (R,): -1 the ground, then the boxes, then the poles; -2
    nothing)."""
    boxes, poles, h = scene["boxes"], scene["poles"], scene["height"]
    t_all = np.full(len(dirs), np.inf)
    hit_all = np.full(len(dirs), -2)
    for s in range(0, len(dirs), chunk):
        d = dirs[s:s + chunk].astype(np.float64)
        r = np.arange(len(d))
        t = np.where(d[:, 2] < 0, -h / np.minimum(d[:, 2], -1e-12), np.inf)
        hit = np.where(np.isfinite(t), -1, -2)
        inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
        t1, t2 = boxes[None, :, :3] * inv[:, None], boxes[None, :, 3:] * inv[:, None]
        near = np.minimum(t1, t2).max(-1)
        far = np.maximum(t1, t2).min(-1)
        tb = np.where((far >= near) & (near > 0), near, np.inf)
        j = tb.argmin(1)
        closer = tb[r, j] < t
        t, hit = np.where(closer, tb[r, j], t), np.where(closer, j, hit)
        # vertical cylinders: |(dx, dy) t - (cx, cy)| = radius, z within the pole
        a = (d[:, :2] ** 2).sum(1)[:, None]
        b = -2 * (d[:, :1] * poles[None, :, 0] + d[:, 1:2] * poles[None, :, 1])
        c = (poles[:, 0] ** 2 + poles[:, 1] ** 2 - poles[:, 2] ** 2)[None]
        disc = b * b - 4 * a * c
        tp = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * np.maximum(a, 1e-12))
        z = d[:, 2:3] * tp
        tp = np.where((disc >= 0) & (tp > 0) & (z >= -h) & (z <= poles[None, :, 3]), tp, np.inf)
        j = tp.argmin(1)
        closer = tp[r, j] < t
        t = np.where(closer, tp[r, j], t)
        hit = np.where(closer, len(boxes) + j, hit)
        t_all[s:s + chunk], hit_all[s:s + chunk] = t, hit
    return t_all, hit_all


def lidar_scan(rng, name, beams=None, steps=None):
    """A seeded scan of dataset ``name``'s LiDAR (``LIDARS``; ``beams`` and
    ``steps`` override its ray count) cast against a fresh ``lidar_scene``:
    dense near the sensor, sparse far away.  Returns coord (N, 3) float32 in
    the sensor's frame, the beam of each point, its train class and its
    instance (0 on the ground, else its object's index + 1)."""
    lidar = LIDARS[name]
    beams, steps = beams or lidar["beams"], steps or lidar["steps"]
    scene = lidar_scene(rng, lidar)
    el = np.deg2rad(np.linspace(*lidar["elevation"], beams))
    az = (np.arange(steps) + rng.rand(steps) * 0.5) * (2 * np.pi / steps)
    el, az = np.meshgrid(el + rng.normal(0, 1e-4, beams), az, indexing="ij")
    dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)],
                    -1).reshape(-1, 3)
    t, hit = cast_rays(dirs, scene)
    expect(bool((hit > -2).all()), f"every ray of the {name} scan met the scene")
    t = t + rng.normal(0, 0.01, t.shape)
    coord = (dirs * t[:, None]).astype(np.float32)
    sector = (np.arctan2(coord[:, 1], coord[:, 0]) % (2 * np.pi)
              * (len(scene["ground"]) / (2 * np.pi))).astype(np.int64)
    sector = np.minimum(sector, len(scene["ground"]) - 1)
    label = np.where(hit < 0, scene["ground"][sector],
                     scene["classes"][np.maximum(hit, 0)])
    instance = np.where(hit < 0, 0, hit + 1)
    beam = np.repeat(np.arange(beams), steps)
    return coord, beam, label.astype(np.int64), instance.astype(np.int64)


def unlabelled(rng, n, share=0.02):
    """A seeded ``share`` of ``n`` points, left without a class."""
    return rng.rand(n) < share


def label_path(scan_path):
    """A SemanticKITTI or Waymo scan's label file, as their datasets find it."""
    return scan_path.replace("velodyne", "labels").replace(".bin", ".label")


def write_semantic_kitti(root, seq, frame, scan, rng, labels=True):
    """A scan in SemanticKITTI's layout under ``root``
    (``dataset/sequences/{seq}/velodyne/{frame}.bin``: x, y, z, remission
    as float32; ``labels/{frame}.label``: uint32, the raw class in the
    lower 16 bits and the instance in the upper 16, some points raw 0 or
    99, both unlabelled).  Returns the .bin's path."""
    from pointcloudpdf_tpu_torch.datasets.semantic_kitti import _TRAIN_TO_RAW

    coord, _, label, instance = scan
    seq_dir = os.path.join(root, "dataset", "sequences", f"{seq:02d}")
    for sub in ("velodyne", "labels"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    path = os.path.join(seq_dir, "velodyne", f"{frame:06d}.bin")
    np.concatenate([coord, rng.rand(len(coord), 1)], 1).astype(np.float32).tofile(path)
    if labels:
        raw = np.array([_TRAIN_TO_RAW[c] for c in range(19)], np.uint32)[label]
        off = unlabelled(rng, len(raw))
        raw[off] = rng.choice(np.array([0, 99], np.uint32), int(off.sum()))
        (raw | (instance.astype(np.uint32) << 16)).tofile(label_path(path))
    return path


def write_nuscenes(root, split, scans, rng, labels=True, sweeps=10):
    """Scans in nuScenes' layout under ``root``: ``raw/samples/LIDAR_TOP/``
    bins of x, y, z, intensity (0-255), ring as float32, ``raw/lidarseg/``
    uint8 lidarseg ids (some 0, unlabelled) and the info pickle
    ``info/nuscenes_infos_{sweeps}sweeps_{split}.pkl`` listing them
    (without ``gt_segment_path`` where ``labels`` is false)."""
    import pickle

    from pointcloudpdf_tpu_torch.datasets.nuscenes import _RAW_TO_TRAIN

    to_raw = {}
    for raw, train_id in sorted(_RAW_TO_TRAIN.items()):
        if train_id is not None:
            to_raw.setdefault(train_id, raw)
    lut = np.array([to_raw[c] for c in range(16)], np.uint8)
    infos = []
    for i, (coord, beam, label, _) in enumerate(scans):
        token = f"{split}{i:04d}"
        info = dict(lidar_token=token, lidar_path=f"samples/LIDAR_TOP/{token}.pcd.bin")
        path = os.path.join(root, "raw", info["lidar_path"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.concatenate([coord, rng.uniform(0, 255, (len(coord), 1)), beam[:, None]],
                       1).astype(np.float32).tofile(path)
        if labels:
            info["gt_segment_path"] = f"lidarseg/v1.0-trainval/{token}_lidarseg.bin"
            seg = lut[label]
            seg[unlabelled(rng, len(seg))] = 0
            path = os.path.join(root, "raw", info["gt_segment_path"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            seg.tofile(path)
        infos.append(info)
    os.makedirs(os.path.join(root, "info"), exist_ok=True)
    with open(os.path.join(root, "info", f"nuscenes_infos_{sweeps}sweeps_{split}.pkl"),
              "wb") as f:
        pickle.dump(infos, f)


def write_waymo(root, split, seq, frame, scan, rng):
    """A scan in the preprocessed Waymo layout under ``root``
    (``{split}/{seq}/velodyne/{frame}.bin``: x, y, z, intensity as float32;
    ``labels/{frame}.label``: int32 pairs (instance, class + 1), some class
    0, unlabelled).  Returns the .bin's path."""
    coord, _, label, instance = scan
    path = os.path.join(root, split, seq, "velodyne", f"{frame:06d}.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    os.makedirs(os.path.dirname(path).replace("velodyne", "labels"), exist_ok=True)
    np.concatenate([coord, rng.exponential(0.3, (len(coord), 1))], 1).astype(
        np.float32).tofile(path)
    cls = label + 1
    cls[unlabelled(rng, len(cls))] = 0
    np.stack([instance, cls], 1).astype(np.int32).tofile(label_path(path))
    return path


def outdoor_data(work):
    """Phase 18's seeded scans under ``work/outdoor``: SemanticKITTI (seq 00
    ``SK_TRAIN_SCANS`` scans linked into ``SK_TRAIN_LINKS`` frames, seq 08 a
    val scan, seq 11 a test scan without labels), nuScenes (a train scan
    listed twice, a val scan) and Waymo (a training scan linked into two
    frames, a validation scan).  The training transforms draw each item's
    augmentation and crop anew.
    Returns the roots and the SemanticKITTI val and test scans' point
    counts."""
    rng = np.random.RandomState(SEED + 18)
    root = os.path.join(work, "outdoor")
    roots = {name: os.path.join(root, name) for name in ("semantic_kitti", "nuscenes", "waymo")}
    t0 = time.perf_counter()
    sk = roots["semantic_kitti"]
    paths = [write_semantic_kitti(sk, 0, i, lidar_scan(rng, "SemanticKITTI"), rng)
             for i in range(SK_TRAIN_SCANS)]
    for i in range(SK_TRAIN_SCANS, SK_TRAIN_LINKS):
        src = paths[i % SK_TRAIN_SCANS]
        dst = os.path.join(os.path.dirname(src), f"{i:06d}.bin")
        for a, b in ((src, dst), (label_path(src), label_path(dst))):
            os.link(a, b)
    counts = {}
    for split, seq in (("val", 8), ("test", 11)):
        scan = lidar_scan(rng, "SemanticKITTI")
        write_semantic_kitti(sk, seq, 0, scan, rng, labels=split == "val")
        counts[split] = len(scan[0])
    write_nuscenes(roots["nuscenes"], "train", [lidar_scan(rng, "nuScenes")] * 2, rng)
    write_nuscenes(roots["nuscenes"], "val", [lidar_scan(rng, "nuScenes")], rng)
    src = write_waymo(roots["waymo"], "training", "segment-0", 0, lidar_scan(rng, "Waymo"),
                      rng)
    dst = os.path.join(os.path.dirname(src), f"{1:06d}.bin")
    for a, b in ((src, dst), (label_path(src), label_path(dst))):
        os.link(a, b)
    write_waymo(roots["waymo"], "validation", "segment-1", 0, lidar_scan(rng, "Waymo"), rng)
    print(f"  scans written in {time.perf_counter() - t0:.1f} s: SemanticKITTI "
          f"{SK_TRAIN_SCANS} train ({SK_TRAIN_LINKS} frames), val and test of "
          f"{LIDARS['SemanticKITTI']['beams'] * LIDARS['SemanticKITTI']['steps']} points; "
          f"nuScenes 1 + 1 of "
          f"{LIDARS['nuScenes']['beams'] * LIDARS['nuScenes']['steps']}; Waymo 1 + 1 of "
          f"{LIDARS['Waymo']['beams'] * LIDARS['Waymo']['steps']}")
    return roots, counts


def curve_ties(grid, mask):
    """PT-v3's curve codes clip each axis at 1,023 (ROADMAP §3 item 17):
    (voxels with an axis past 1,023, voxels whose clipped cell another voxel
    of the sample shares) over a batch's (B, N, 3) grid."""
    past = tied = 0
    for g, m in zip(np.asarray(grid), np.asarray(mask, bool)):
        g = g[m]
        past += int((g > 1023).any(1).sum())
        tied += len(g) - len(np.unique(np.minimum(g, 1023), axis=0))
    return past, tied


def config_with_roots(config, roots, options):
    """``config`` parsed with every dataset's ``data_root`` at ``roots``
    (by dataset type; a PPT config's three train datasets too) and
    ``options``."""
    from pointcloudpdf_tpu_torch.engines import default_config_parser

    by_type = {"SemanticKITTIDataset": roots["semantic_kitti"],
               "NuScenesDataset": roots["nuscenes"], "WaymoDataset": roots["waymo"]}
    cfg = default_config_parser(config, options)
    for split in ("train", "val", "test"):
        ds = cfg.data.get(split)
        if ds is None:
            continue
        for d in ds.get("datasets", [ds]):
            d.data_root = by_type[d.type]
    return cfg


def outdoor_steps(work, config, name, roots, steps=1, sizes=(OUTDOOR_STEP_BATCH, 1),
                  timed=False):
    """``steps`` training steps of ``config`` at full width at the first
    batch size of ``sizes`` that fits the card, on its own loader's batches
    (a PPT config's ``MultiDatasetTrainer`` draws one dataset a batch),
    autocast and Mix3D as shipped: finite losses, no kernel of K1-K7, the
    peak; with ``timed`` the last batch's step again, three times by CUDA
    events after a warm-up."""
    import torch

    for batch_size in sizes:
        try:
            out = steps_at(work, config, name, roots, steps, batch_size, timed)
        except torch.cuda.OutOfMemoryError:
            print(f"  {name}: batch {batch_size} does not fit the card's memory")
        else:
            break
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise SmokeFailure(f"{name}: no batch size of {list(sizes)} fits the card's memory")
    out["batch_size"] = batch_size
    return out


def steps_at(work, config, name, roots, steps, batch_size, timed):
    """``outdoor_steps`` at one batch size."""
    import torch

    from pointcloudpdf_tpu_torch.engines.defaults import batch_condition
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.models.point_transformer_v3 import ptv3

    cfg = config_with_roots(config, roots, {
        "save_path": os.path.join(work, f"exp_{name}"), "device": DEVICE,
        "batch_size": batch_size, "num_worker": 4, "evaluate": False, "hooks": [],
        "seed": SEED})
    torch.manual_seed(SEED)
    trainer = TRAINERS.build(dict(type=cfg.get("train", {}).get("type", "DefaultTrainer"),
                                  cfg=cfg))
    loader = iter(trainer.train_loader)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, shapes, ties = [], [], None
    for _ in range(steps):
        input_dict = next(loader)
        if isinstance(trainer.model.backbone, ptv3.PointTransformerV3):
            ties = curve_ties(input_dict["grid_coord"],
                              np.arange(input_dict["grid_coord"].shape[1])[None]
                              < input_dict["count"][:, None])
        trainer.comm_info["input_dict"] = input_dict
        trainer.run_step()
        losses.append(float(trainer.comm_info["model_output_dict"]["loss"]))
        shapes.append((list(input_dict["coord"].shape), batch_condition(input_dict)))
    no_kernel_launched(read_launches(), f"{name}'s steps")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = dict(losses=losses, peak=peak, shapes=shapes, ties=ties)
    if timed:
        batch = trainer.device_batch(input_dict)
        trainer._dispatch_train(batch)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            trainer._dispatch_train(batch)
        end.record()
        torch.cuda.synchronize()
        out["step_ms"] = start.elapsed_time(end) / 3
        out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {name}: {steps} step(s) at batch {batch_size} on {shapes}: losses "
          f"{losses}, peak {out['peak']:.2f} GiB"
          + (f", PT-v3 voxels past cell 1,023 {ties[0]}, their curve cells tied {ties[1]}"
             if ties else "") + (f", a step {out['step_ms']:.1f} ms" if timed else ""))
    expect(all(np.isfinite(losses)), f"{name}: finite losses")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def k7_shapes(model, fn):
    """The (valid queries, C, groups, neighbours) of each K7-eligible
    attention of ``model`` in one call of ``fn``."""
    from pointcloudpdf_tpu_torch.models.point_transformer_v2.ptv2 import (
        GroupedVectorAttention)

    shapes = set()

    def record(module, args, _):
        feat, _, ref_idx, _, mask = args[:5]
        shapes.add((int(mask.sum()), feat.shape[-1], module.groups, ref_idx.shape[-1]))

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, GroupedVectorAttention)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return sorted(shapes, key=lambda s: (s[1], -s[0]))


def serve_outdoor_ptv2(work, roots, n_val):
    """Phase 18(a): ``tools/test_torch.py`` on the shipped SemanticKITTI
    PT-v2m2 config over the val scan, seeded random weights through the
    bridge: K7 and K1 launched as the modules fix them
    (``SK_PTV2_PER_FORWARD``, ``SK_PTV2_K7_BY_WIDTH``), both K1 kernels, none
    dropped; then the largest fragment on the plain versions and, on a
    crop, on the CPU; its forward timed and profiled.  Returns (launches,
    weight, fragment result)."""
    import copy

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _profile_torch import profile_call

    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn
    from pointcloudpdf_tpu_torch.engines.test import TESTERS
    from pointcloudpdf_tpu_torch.models import build_model
    from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2
    from pointcloudpdf_tpu_torch.ops import _cuda

    root = roots["semantic_kitti"]
    cfg = config_with_roots(SK_PTV2_CONFIG, roots, {})
    torch.manual_seed(SEED)
    weight = os.path.join(work, "model_sk_ptv2.pth")
    random_jax_checkpoint(weight, build_model(dict(cfg.model)))
    save_path = os.path.join(work, "exp_sk_ptv2")
    ptv2.capacity_dropped_points(reset=True)
    reset_launches()
    t0 = time.perf_counter()
    log = run_tool("test_torch.py", [
        "--config-file", SK_PTV2_CONFIG, "--device", DEVICE, "--options",
        f"data_root={root}", f"weight={weight}", f"save_path={save_path}",
        f"data.test.data_root={root}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    launches.update(read_knn_kernels())
    by_width = launches.pop("gva_by_width")
    forwards = log.count(", Batch: ")
    print(f"  tools/test_torch.py (SemSegTester): {wall:.3f} s a scan, {forwards} forwards; "
          f"launches {launches}, K7 by width {by_width}")
    expect(forwards > 0, f"{forwards} forwards")
    for key in ("gva", "knn", "fps", "vector_attention", "st_attention", "kpconv"):
        want = SK_PTV2_PER_FORWARD.get(key, 0) * forwards
        expect(launches[key] == want, f"{key} kernel launched {launches[key]} times = "
                                      f"{SK_PTV2_PER_FORWARD.get(key, 0)} a forward x "
                                      f"{forwards} forwards")
    expect(launches.pop("vector_attention_train") == (0, 0), "serving launched no training kernel")
    # every level is held at the fragment's padded length (the config's
    # capacity factor 1.0) and K1 takes its kernel by that length
    # (``KNN_PRUNE_MIN_REFS``): the bound-pruned one at every level here
    expect(launches["knn_pruned"] > 0, f"K1 launched on the LiDAR scan: "
           f"{launches['knn_pruned']} bound-pruned, {launches['knn_brute']} brute-force")
    want = {c: n * forwards for c, n in SK_PTV2_K7_BY_WIDTH.items()}
    expect(by_width == want, f"K7 launched {by_width} times by width = {want}")
    dropped = ptv2.capacity_dropped_points(reset=True)
    expect(dropped == 0, f"{dropped} points dropped by a pooling capacity")
    pred = np.load(os.path.join(save_path, "result", "08_000000_pred.npy"))
    expect("Val result: mIoU/mAcc/allAcc" in log and pred.shape == (n_val,)
           and pred.min() >= 0 and pred.max() < 19,
           f"pred covers the val scan's {n_val} points, in [0, 19)")

    cfg.merge_from_dict({"weight": weight, "device": DEVICE,
                         "save_path": os.path.join(work, "exp_sk_ptv2_check")})
    tester = TESTERS.build(dict(type="SemSegTester", cfg=cfg))
    fragments = tester.test_dataset[0]["fragment_list"]
    fragment = max(fragments, key=lambda f: len(f["coord"]))
    n = len(fragment["coord"])
    print(f"  {len(fragments)} fragments of up to {n} points")
    fragment_against_plain(tester, fragment)
    crop = crop_fragment(fragment, CPU_CROP)
    card = tester.forward_fragment(crop)["seg_logits"]
    cpu_model = copy.deepcopy(tester.model).cpu()
    cpu_batch = {k: v.cpu() if torch.is_tensor(v) else v
                 for k, v in tester.device_batch(padded_collate_fn([crop])).items()}
    with torch.inference_mode():
        cpu = cpu_model(cpu_batch)["seg_logits"][0, :len(card)].numpy()
    lmax, lerr = float(np.abs(cpu).max()), float(np.abs(card - cpu).max())
    print(f"  a crop of {len(crop['coord'])} points, card against CPU: logits err "
          f"{lerr:.3e} (max |logit| {lmax:.3e})")
    expect(lerr <= TOL_LOGITS * lmax, f"card within {TOL_LOGITS} x max |logit| of the CPU")

    batch = tester.device_batch(padded_collate_fn([fragment]))

    def forward():
        with torch.inference_mode():
            tester.forward(batch)

    shapes = k7_shapes(tester.model, forward)
    ms = cuda_ms(forward, 3)
    with _cuda.plain_versions():
        plain_ms = cuda_ms(forward, 1)
    prof = profile_call(forward, ms, "SemanticKITTI PT-v2m2 fragment forward", top=8)
    k7_ms = prof["by_kind_ms"].get("K7 grouped vector attention", 0.0)
    print(f"  the largest fragment ({n} points, bucket {batch['coord'].shape[1]}): kernels "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, K7 {k7_ms:.3f} ms ({k7_ms / ms:.3f} of it), "
          f"idle {prof['idle_share_unprofiled']:.3f}; K7 shapes (valid queries, C, G, "
          f"neighbours) {shapes}")
    ties = curve_ties(fragment["grid_coord"][None], np.ones((1, n), bool))
    return launches, weight, dict(ms=ms, plain_ms=plain_ms, k7_ms=k7_ms, points=n,
                                  scan_s=wall, forwards=forwards, k7_shapes=shapes,
                                  val_ties=ties, idle=prof["idle_share_unprofiled"])


def run_outdoor_submit(work, roots, weight, n_test):
    """Phase 18(e): ``tools/test_torch.py`` on the shipped SemanticKITTI
    PT-v2m2 benchmark-submit config over the test scan (no labels): its
    ``submit/sequences/11/predictions/000000.label`` holds one uint32 a
    point, each the raw id of ``learning_map_inv`` of the pred."""
    from pointcloudpdf_tpu_torch.datasets.semantic_kitti import _TRAIN_TO_RAW

    root = roots["semantic_kitti"]
    save_path = os.path.join(work, "exp_sk_submit")
    run_tool("test_torch.py", [
        "--config-file", SK_SUBMIT_CONFIG, "--device", DEVICE, "--options",
        f"data_root={root}", f"weight={weight}", f"save_path={save_path}",
        f"data.test.data_root={root}"])
    path = os.path.join(save_path, "result", "submit", "sequences", "11", "predictions",
                        "000000.label")
    expect(os.path.isfile(path), f"the submission file {os.path.relpath(path, work)}")
    raw = np.fromfile(path, dtype=np.uint32)
    pred = np.load(os.path.join(save_path, "result", "11_000000_pred.npy"))
    lut = np.array([_TRAIN_TO_RAW[c] for c in range(19)], np.uint32)
    print(f"  submission: {len(raw)} uint32 labels, raw ids {np.unique(raw).tolist()}")
    expect(len(raw) == n_test and np.array_equal(raw, lut[pred]),
           f"one raw id a point of the test scan ({n_test}), learning_map_inv of the pred")


def run_outdoor_waymo(work, roots):
    """Phase 18(c): the shipped Waymo SpUNet config's tester on the
    validation scan (walls at 74 m: past 2,048 cells in x and y at 5 cm),
    seeded random weights: the largest fragment's voxel maps on the card
    bit-equal to the CPU's (``check_fragment_maps``), its logits on a band
    along x (``WAYMO_BAND`` about the sensor's y: the full x extent, few
    points) within ``TOL_SPUNET_LOGITS`` of the CPU's, nothing dropped."""
    import torch

    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn
    from pointcloudpdf_tpu_torch.engines.test import TESTERS
    from pointcloudpdf_tpu_torch.models import build_model

    cfg = config_with_roots(WAYMO_SPUNET_CONFIG, roots, {})
    torch.manual_seed(SEED)
    weight = os.path.join(work, "model_waymo_spunet.pth")
    random_jax_checkpoint(weight, build_model(dict(cfg.model)))
    cfg.merge_from_dict({"weight": weight, "device": DEVICE,
                         "save_path": os.path.join(work, "exp_waymo_check")})
    tester = TESTERS.build(dict(type="SemSegTester", cfg=cfg))
    tester.load_weights()
    fragments = tester.test_dataset[0]["fragment_list"]
    fragment = max(fragments, key=lambda f: len(f["coord"]))
    grid = fragment["grid_coord"]
    extent = (grid.max(0) - grid.min(0) + 1).tolist()
    print(f"  {len(fragments)} fragments of up to {len(grid)} points; the largest spans "
          f"{extent} cells")
    expect(min(extent[:2]) > 2048, "the Waymo scan spans more than 2,048 cells in x and y")
    # the walls stand at the same distance on both sides of the sensor
    sensor_y = float(fragment["coord"][:, 1].min() + fragment["coord"][:, 1].max()) / 2

    def band(f):
        keep = np.abs(f["coord"][:, 1] - sensor_y) <= WAYMO_BAND
        n = len(keep)
        part = {k: v[keep] if isinstance(v, np.ndarray) and len(v) == n else v
                for k, v in f.items()}
        span = part["grid_coord"][:, 0].max() - part["grid_coord"][:, 0].min() + 1
        expect(span >= 0.95 * extent[0], f"the band spans {span} of {extent[0]} cells in x")
        return part

    reset_launches()
    check_fragment_maps(tester, fragment, tester.device_batch(padded_collate_fn([fragment])),
                        name="SpUNet (Waymo)", cpu_crop=band)
    no_kernel_launched(read_launches(), "the Waymo SpUNet forward")
    return dict(points=len(grid), extent=extent)


def run_outdoor_slice(work):
    """Phase 18: (a) serving the shipped SemanticKITTI PT-v2m2 config, (b)
    training, evaluating and testing the SemanticKITTI SpUNet config at full
    width, (c) the Waymo SpUNet config on a full-extent scan, (d) a step of
    MinkUNet34C, PT-v3m1, the nuScenes SpUNet config and PPT-v1m1 over the
    three datasets, (e) the SemanticKITTI benchmark-submit tester; over
    ``outdoor_data``'s scans."""
    import re

    import torch

    from pointcloudpdf_tpu_torch.ops import voxel

    walls = {}
    t0 = time.perf_counter()
    roots, counts = outdoor_data(work)
    walls["data"] = time.perf_counter() - t0

    print("  (a) tools/test_torch.py on the shipped SemanticKITTI PT-v2m2 config")
    t0 = time.perf_counter()
    serving, weight, served = serve_outdoor_ptv2(work, roots, counts["val"])
    walls["a"] = time.perf_counter() - t0

    print("  (b) tools/train_torch.py on the SemanticKITTI SpUNet config at full width, "
          "then the tester")
    t0 = time.perf_counter()
    root = roots["semantic_kitti"]
    log, batch_size, iters, wall, launches, peak, save_path = train_with_fallback(
        work, SK_SPUNET_CONFIG, "sk_spunet", root, 1, [f"data.test.data_root={root}"],
        subsample=False, sizes=SPUNET_TRAIN_BATCHES, samples=SK_TRAIN_LINKS)
    dropped = voxel.capacity_dropped_points(reset=True)
    no_kernel_launched(launches, "SpUNet training and its evaluator")
    losses = train_log_losses(log, iters)["loss"]
    print(f"  losses {losses}; dropped by the level capacities {dropped}")
    for line in re.findall(r"Val result: [^\n]*", log):
        print("  " + line)
    expect("Val result: mIoU/mAcc/allAcc" in log, "the evaluator ran")
    expect(dropped == 0, f"{dropped} points dropped by the level capacities")
    test_save = os.path.join(work, "exp_sk_spunet_test")
    run_tool("test_torch.py", [
        "--config-file", SK_SPUNET_CONFIG, "--device", DEVICE, "--options",
        f"data_root={root}", f"weight={os.path.join(save_path, 'model', 'model_last.pth')}",
        f"save_path={test_save}", f"data.test.data_root={root}"])
    pred = np.load(os.path.join(test_save, "result", "08_000000_pred.npy"))
    expect(pred.shape == (counts["val"],),
           f"tools/test_torch.py tested the trainer's checkpoint: pred of {counts['val']} points")
    gc.collect()
    torch.cuda.empty_cache()
    spunet = outdoor_steps(work, SK_SPUNET_CONFIG, "SemanticKITTI SpUNet", roots,
                           sizes=(batch_size,), timed=True)
    spunet.update(batch_size=batch_size, train_peak=peak, train_wall=wall)
    print(f"  SemanticKITTI SpUNet: training at batch {batch_size} (shipped 12), peak "
          f"{peak:.2f} GiB; a step {spunet['step_ms']:.1f} ms, peak {spunet['peak']:.2f} GiB")
    walls["b"] = time.perf_counter() - t0

    print("  (c) the Waymo SpUNet config on a full-extent scan")
    t0 = time.perf_counter()
    waymo = run_outdoor_waymo(work, roots)
    walls["c"] = time.perf_counter() - t0

    print("  (d) a step of MinkUNet34C, PT-v3m1, nuScenes SpUNet, PPT-v1m1 over the three "
          "datasets")
    t0 = time.perf_counter()
    steps = {name: outdoor_steps(work, config, name, roots, steps=n)
             for name, config, n in (("MinkUNet34C", SK_MINK_CONFIG, 1),
                                     ("SemanticKITTI PT-v3m1", SK_PTV3_CONFIG, 1),
                                     ("nuScenes SpUNet", NU_SPUNET_CONFIG, 1),
                                     ("PPT-v1m1", SK_PPT_CONFIG, 3))}
    conditions = [c for _, c in steps["PPT-v1m1"]["shapes"]]
    expect(sorted(conditions) == ["SemanticKITTI", "Waymo", "nuScenes"],
           f"PPT-v1m1's three steps drew one batch of each dataset: {conditions}")
    walls["d"] = time.perf_counter() - t0

    print("  (e) the SemanticKITTI PT-v2m2 benchmark-submit tester")
    t0 = time.perf_counter()
    run_outdoor_submit(work, roots, weight, counts["test"])
    walls["e"] = time.perf_counter() - t0
    print("  phase 18 walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return serving, dict(served=served, spunet=spunet, waymo=waymo, steps=steps)


def main() -> int:
    if not os.path.isfile(os.path.join(ROOT, "pointcloudpdf_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke.py: the port (pointcloudpdf_tpu_torch/) is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    print("[1] card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("[2] build")
    from pointcloudpdf_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.library()
    print(f"  built {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.1f} s")
    compiled = print_compiler_report(so[:-3] + ".log")

    print("[3] kernels against their plain versions")
    rng = np.random.RandomState(SEED)
    knn = check_knn(dev, rng)
    results = {"knn_pruned": dict(knn["pruned"], max_abs_err=knn["max_abs_err"]),
               "knn_brute": dict(knn["brute"], max_abs_err=knn["max_abs_err"]),
               "fps": check_fps(dev, rng, compiled),
               "vector_attention": check_attention(dev, rng, compiled),
               "vector_attention_train": check_attention_train(dev, rng),
               "st_attention": check_st_attention(dev, rng, compiled),
               "kpconv": check_kpconv(dev, rng, compiled),
               "gva": check_gva(dev, rng, compiled)}

    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        print(f"  phase wall time: {walls[name]:.1f} s")
        return out

    with tempfile.TemporaryDirectory() as work:
        print("[4] serving slice end to end")
        serving = phase("4", run_slice, work, CONFIG, "pt")
        print("[5] training slice end to end")
        launches, data_root, batch_size, peak, base_weight, n_val = phase(
            "5", run_training_slice, work)
        print("[6] three train steps, kernels against plain versions")
        phase("6", compare_train_steps, work, data_root)
        print("[7] Stratified Transformer serving slice end to end")
        st_serving = phase("7", run_slice, work, ST_CONFIG, "st", ST_PER_FORWARD)
        print("[8] Point Transformer V2 serving slice end to end")
        ptv2_serving = phase("8", run_slice, work, PTV2_CONFIG, "ptv2",
                             PTV2_PER_FORWARD, PTV2_K7_BY_WIDTH)
        print("[9] Stratified Transformer open-set training slice end to end")
        st_train, st_batch, st_peak = phase("9", run_st_training_slice, work,
                                            data_root, n_val)
        print("[10] incremental slice end to end")
        incr_train, incr_batch, incr_peak = phase("10", run_incr_slice, work,
                                                  data_root, n_val, base_weight)
        print("[11] PT-v2 training slice end to end")
        ptv2_train, ptv2_batch, ptv2_peak, cac = phase(
            "11", run_ptv2_training_slice, work, data_root, n_val)
        print("[12] data-parallel engine: two gloo ranks on the card, NCCL at "
              "world 1, the tester on two ranks")
        ddp_train, ddp = phase("12", run_ddp_slice, work, data_root)
        print("[13] the SpUNet family: serving and training the shipped S3DIS "
              "SpUNet config, MinkUNet34C, CAC-v1m1 over SpUNet, SpUNet-v1m3")
        spunet_serving, spunet = phase("13", run_spunet_slice, work, data_root, n_val)
        print("[14] PT-v3m1: serving and training the shipped S3DIS -rpe config, a "
              "step of the ScanNet config")
        ptv3_serving, ptv3 = phase("14", run_ptv3_slice, work, data_root)
        print("[15] Point Prompt Training: training, evaluating and testing the shipped "
              "S3DIS PPT config, a PT-v3 PPT-extreme step, a PPT-v1m2 step")
        ppt = phase("15", run_ppt_slice, work)
        print("[16] Swin3D and OctFormer: serving and training the shipped S3DIS "
              "Swin3D-small and ScanNet OctFormer configs")
        swin_serving, swin_train, window = phase("16", run_window_slice, work)
        print("[17] instance segmentation and OA-CNNs: training and evaluating the shipped "
              "S3DIS PointGroup config, steps of the other PointGroup configs, serving and "
              "training the shipped ScanNet OA-CNNs config")
        pg, oacnns = phase("17", run_insseg_slice, work)
        window["oacnns"] = oacnns
        print("[18] outdoor LiDAR: serving the shipped SemanticKITTI PT-v2m2 config, training "
              "its SpUNet config, Waymo SpUNet on a full-extent scan, steps of MinkUNet34C, "
              "PT-v3m1, nuScenes SpUNet and PPT-v1m1 over the three datasets, the "
              "benchmark-submit tester")
        outdoor_serving, outdoor = phase("18", run_outdoor_slice, work)
        served, sk_step = outdoor["served"], outdoor["spunet"]
        print(f"  {card}: SemanticKITTI PT-v2m2 serving {served['scan_s']:.2f} s a scan "
              f"({served['forwards']} forwards), {served['ms']:.2f} ms a fragment of "
              f"{served['points']} points (plain {served['plain_ms']:.2f}), K7 "
              f"{served['k7_ms']:.3f} ms of it, idle {served['idle']:.3f}; SpUNet train step "
              f"{sk_step['step_ms']:.1f} ms at batch {sk_step['batch_size']} (shipped 12), "
              f"peak {sk_step['peak']:.2f} GiB (training run {sk_step['train_peak']:.2f}); "
              f"peaks of the other steps "
              f"{ {k: (v['batch_size'], round(v['peak'], 2)) for k, v in outdoor['steps'].items()} }"
          f" (batch, GiB); PT-v3 "
              f"voxels past cell 1,023 and tied curve cells: the val scan's fragment "
              f"{served['val_ties']}, the step's batch "
              f"{outdoor['steps']['SemanticKITTI PT-v3m1']['ties']}")
        print(f"  {card}: PointGroup train step {pg['step_ms']:.1f} ms at batch "
              f"{pg['batch_size']} (shipped 12), {pg['shape']}, peak {pg['peak']:.2f} GiB "
              f"(training run {pg['train_peak']:.2f}), idle {pg['idle']:.3f}, indexing "
              f"backward share {pg['share']:.4f}; mAP {pg['m_ap']:.4f}, AP50 "
              f"{pg['m_ap50']:.4f}, AP25 {pg['m_ap25']:.4f}; proposals a val scene "
              f"{pg['proposals']}, host clustering ms a scene "
              f"{[round(t, 1) for t in pg['propose_ms']]}; peaks of the other configs' steps "
              f"{ {k: round(v, 2) for k, v in pg['other_peaks'].items()} } GiB")
        for name, step in window.items():
            served = step["serving"]
            print(f"  {card}: {name} serving {served['ms']:.2f} ms a fragment of "
                  f"{served['points']} points (bucket {served['bucket']}), busy "
                  f"{served['busy_ms']:.2f} ms, idle {served['idle']:.3f}, levels valid "
                  f"{served['valid_rows']} held {served['held_rows']}; train step "
                  f"{step['step_ms']:.1f} ms at batch {step['batch_size']} (shipped 12), "
                  f"{step['shape']}, peak {step['peak']:.2f} GiB (training run at "
                  f"{step['train_batch_size']}: {step['train_peak']:.2f}), idle "
                  f"{step['idle']:.3f}, levels valid "
                  f"{step['valid_rows']} held {step['held_rows']}, indexing backward "
                  f"share {step['share']:.4f}")
        served = ppt["serving"]
        print(f"  {card}: PPT train step {ppt['step_ms']:.1f} ms at batch "
              f"{ppt['batch_size']} (shipped 12), {ppt['shape']}, peak {ppt['peak']:.2f} GiB "
              f"(training run {ppt['train_peak']:.2f}), indexing backward share "
              f"{ppt['share']:.4f}; serving {served['ms']:.2f} ms a fragment of "
              f"{served['points']} points (bucket {served['bucket']}); PT-v3 PPT-extreme "
              f"batch {ppt['v3']['batch_size']} (shipped 24), peak {ppt['v3']['peak']:.2f} GiB")
        served = ptv3["serving"]
        print(f"  {card}: PT-v3 serving {served['ms']:.2f} ms a fragment of "
              f"{served['points']} points (bucket {served['bucket']}), busy "
              f"{served['busy_ms']:.2f} ms, idle {served['idle']:.3f}; train step "
              f"{ptv3['step_ms']:.1f} ms at batch {ptv3['batch_size']} (shipped 12), "
              f"{ptv3['shape']}, peak {ptv3['peak']:.2f} GiB, indexing backward share "
              f"{ptv3['share']:.4f}; ScanNet step peak {ptv3['scannet_peak']:.2f} GiB")
        print(f"  {card}: SpUNet train step {spunet['step_ms']:.1f} ms at batch "
              f"{spunet['batch_size']} (shipped 12), peak {spunet['peak']:.2f} GiB, "
              f"indexing backward share {spunet['share']:.4f}")
        print(f"  {card}: phase 12 wall {walls['12']:.1f} s; step ms world 1 "
              f"{[round(t, 1) for t in ddp['step_ms'][1]]}, world 2 "
              f"{[round(t, 1) for t in ddp['step_ms'][2]]} (global batch "
              f"{ddp['batch_size']}); gradient all-reduce ms "
              f"{[round(t, 1) for t in ddp['allreduce_ms']]} ({ddp['all_reduces']} "
              f"tensor all-reduces a rank over 3 steps); peak GiB world 1 "
              f"{ddp['one_peak']:.2f}, a rank {[round(p, 2) for p in ddp['peak']]}")
    print("  phase wall times (s): " + ", ".join(
        f"[{k}] {v:.1f}" for k, v in walls.items()))
    print(f"  training batch sizes (shipped 16) and peak device memory: PT-v1 "
          f"{batch_size} ({peak:.2f} GiB), ST {st_batch} ({st_peak:.2f} GiB), "
          f"incremental {incr_batch} ({incr_peak:.2f} GiB); PT-v2m2 (shipped 12) "
          f"{ptv2_batch} ({ptv2_peak:.2f} GiB)")

    main_runs = (launches, serving, st_serving, ptv2_serving, st_train, incr_train,
                 ptv2_train, ddp_train, swin_serving, swin_train, outdoor_serving)
    n = sum(run[key] for run in (swin_serving, swin_train)
            for key in ("knn_pruned", "knn_brute"))
    expect(swin_serving["knn"] > 0 and n > swin_serving["knn"],
           f"K1 launched on the Swin3D path: {swin_serving['knn']} serving, "
           f"{n - swin_serving['knn']} training")
    for key in ("knn_pruned", "knn_brute"):
        n = sum(run[key] for run in main_runs)
        expect(n > 0, f"{key} kernel launched {n} times over the main-path runs")

    meta = {
        "knn_pruned": ("K1 exact kNN, bound-pruned (ref sets >= KNN_PRUNE_MIN_REFS)",
                       "pointcloudpdf_tpu_torch/csrc/knn.cu",
                       "pointcloudpdf_tpu/ops/pallas_knn.py:334"),
        "knn_brute": ("K1 exact kNN, brute force (smaller ref sets)",
                      "pointcloudpdf_tpu_torch/csrc/knn.cu",
                      "pointcloudpdf_tpu/ops/pallas_knn.py:231"),
        "fps": ("K2 farthest point sampling", "pointcloudpdf_tpu_torch/csrc/fps.cu",
                "pointcloudpdf_tpu/ops/pallas_fps.py:70"),
        "vector_attention": ("K3 vector attention (inference)",
                             "pointcloudpdf_tpu_torch/csrc/vector_attention.cu",
                             "pointcloudpdf_tpu/ops/pallas_attention.py:173"),
        "vector_attention_train": (
            "K4 vector attention (training forward + backward)",
            "pointcloudpdf_tpu_torch/csrc/vector_attention_bwd.cu",
            "pointcloudpdf_tpu/ops/pallas_attention.py:527"),
        "st_attention": ("K5 cRPE window attention (inference)",
                         "pointcloudpdf_tpu_torch/csrc/st_attention.cu",
                         "pointcloudpdf_tpu/ops/pallas_st_attention.py:155"),
        "kpconv": ("K6 KPConv (inference)",
                   "pointcloudpdf_tpu_torch/csrc/kpconv.cu",
                   "pointcloudpdf_tpu/ops/pallas_kpconv.py:156"),
        "gva": ("K7 grouped vector attention (inference)",
                "pointcloudpdf_tpu_torch/csrc/gva.cu",
                "pointcloudpdf_tpu/ops/pallas_gva.py:134"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        r = results[key]
        # launches: over the seven main-path runs, each read from its own
        # run with the counts set to 0 just before it: launches_train (the
        # PT-v1 training slice; K4 forward + backward), launches_st_train
        # (the ST training slice), launches_incr_train (the incremental
        # slice; K4 forward + backward), launches_ptv2_train (the PT-v2
        # training slice: its training, evaluator and tester forwards; the
        # CAC step beside it is not counted), launches_pt_serving,
        # launches_st_serving and launches_ptv2_serving (launches_serving:
        # the three serving slices; launches_serving adds
        # launches_swin3d_serving, phase 16(a)), launches_swin3d_train
        # (phase 16(b): Swin3D's training, evaluator and tester forwards),
        # launches_ddp_train (phase 12(a): both
        # ranks' counts, each set to 0 just before its steps; the
        # one-process reference beside them is not counted),
        # launches_outdoor_serving (phase 18(a): the SemanticKITTI PT-v2m2
        # tester over a LiDAR scan; also in launches_serving); library_ms: no
        # single PyTorch call
        # computes any of these functions (cdist + topk, a loop of argmax, a
        # chain of gathers and matmuls; scaled_dot_product_attention has no
        # per-pair table terms or MLPs and no gathered keys, a convolution
        # no kernel-point influences)
        n_train, n_st_train, n_incr, n_v2_train, n_ddp = (
            sum(n) if isinstance(n, tuple) else n
            for n in (launches[key], st_train[key], incr_train[key], ptv2_train[key],
                      ddp_train[key]))
        n_pt, n_st = serving.get(key, 0), st_serving.get(key, 0)
        n_v2 = ptv2_serving.get(key, 0)
        n_swin, n_swin_train = swin_serving.get(key, 0), swin_train.get(key, 0)
        n_outdoor = outdoor_serving.get(key, 0)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": (n_train + n_pt + n_st + n_v2 + n_st_train
                                     + n_incr + n_v2_train + n_ddp + n_swin + n_swin_train
                                     + n_outdoor),
                        "launches_train": n_train,
                        "launches_st_train": n_st_train,
                        "launches_incr_train": n_incr,
                        "launches_ptv2_train": n_v2_train,
                        "launches_ddp_train": n_ddp,
                        "launches_pt_serving": n_pt,
                        "launches_st_serving": n_st,
                        "launches_ptv2_serving": n_v2,
                        "launches_swin3d_serving": n_swin,
                        "launches_swin3d_train": n_swin_train,
                        "launches_outdoor_serving": n_outdoor,
                        "launches_serving": n_pt + n_st + n_v2 + n_swin + n_outdoor,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "shape": r["shape"]})
        if "wrapper_ms" in r:
            kernels[-1]["wrapper_ms"] = r["wrapper_ms"]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
