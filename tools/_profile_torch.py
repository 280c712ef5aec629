"""What the port's profiling tools share: the card's name line, the split of
one profiled call's device time by kind of kernel, the JSON record, and the
whole profile of one serving forward through a tester.

Used by ``tools/profile_train_torch.py``, ``tools/profile_ptv1_torch.py``,
``tools/profile_st_torch.py`` and ``tools/profile_ptv2_torch.py``.
"""

import json
import os
import subprocess
import time

# a kernel's kind is the first whose keys its name holds; K1 in three:
# the brute-force kernel (K1a), the bound-pruned kernel (K1b) and its prep
# (the prep kernels and the PyTorch sorts of the ``K1 prep`` range)
K1_BRUTE, K1_PRUNED, K1_PREP = "K1a kNN brute force", "K1b kNN pruned", "K1b kNN prep"
K1_KINDS = (K1_BRUTE, K1_PRUNED, K1_PREP)
KINDS = (
    (K1_PRUNED, ("knn_kernel_pruned",)),
    # knn_kernel<K>: the one-thread-a-query brute-force kernel of earlier
    # trees, profiled with these tools to compare against them
    (K1_BRUTE, ("knn_brute_kernel", "knn_kernel<")),
    (K1_PREP, ("knn_prep",)),
    ("K2 FPS", ("fps_",)),
    ("K4 backward", ("attn_bwd_kernel",)),
    ("K5 window attention", ("st_attention_kernel",)),
    ("K4 forward / K3", ("attn_kernel",)),
    ("K6 KPConv", ("kpconv_kernel",)),
    ("K7 grouped vector attention", ("gva_kernel",)),
    ("GEMM", ("gemm", "cutlass", "cublas", "gemv")),
    ("sort", ("sort", "radix")),
    ("optimizer", ("multi_tensor", "foreach", "fused_sgd")),
    ("gather/scatter", ("index", "gather", "scatter", "take_along")),
    ("reduce", ("reduce",)),
)


def kind_of(name):
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "element-wise and other"


def range_kernels(prof, name):
    """{kernel name: [device us, launches]} of the PyTorch kernels launched
    inside the ranges ``name``: ``K1 prep`` (the sorts of the pruned kNN's
    plan, which belong to K1, not to "sort"), ``K7 pack`` (K7's parameter
    packing)."""
    import torch

    moved = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        parent = ev.cpu_parent
        while parent is not None and parent.name != name:
            parent = parent.cpu_parent
        if parent is None:
            continue
        for kern in ev.kernels:
            entry = moved.setdefault(kern.name, [0.0, 0])
            entry[0] += kern.duration
            entry[1] += 1
    return moved


def device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def profile_call(fn, host_ms, what, top=24):
    """One call of ``fn`` under ``torch.profiler``: the device's busy time,
    its idle share (of the profiled wall time, and of ``host_ms``, the
    unprofiled host clock of the same call), the split by kind of kernel and
    the ``top`` kernels.  Prints them and returns them as a dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds, launches = {}, {}
    averages = prof.key_averages()
    # the ranges' kernels are looked up (a walk over every event) where a
    # range ran at all
    ranges = {ev.key for ev in averages} & {"K1 prep", "K7 pack"}
    # (a record_function range shows on the device's timeline too: not a kernel)
    kernels = [ev for ev in averages
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and device_us(ev) > 0 and ev.key not in ("K1 prep", "K7 pack")]
    for ev in kernels:
        k = kind_of(ev.key)
        kinds[k] = kinds.get(k, 0.0) + device_us(ev) / 1e3
        launches[k] = launches.get(k, 0) + ev.count
    prep = range_kernels(prof, "K1 prep") if "K1 prep" in ranges else {}
    for name, (us, n) in prep.items():
        k = kind_of(name)
        if k not in K1_KINDS:
            kinds[k] -= us / 1e3
            launches[k] -= n
            kinds[K1_PREP] = kinds.get(K1_PREP, 0.0) + us / 1e3
            launches[K1_PREP] = launches.get(K1_PREP, 0) + n
    busy = sum(kinds.values())
    print(f"profiled {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms over "
          f"{sum(launches.values())} kernels, idle share {1 - busy / wall_ms:.3f} "
          f"(profiled), {1 - busy / host_ms:.3f} against the unprofiled host clock; "
          f"K1 {sum(kinds.get(k, 0.0) for k in K1_KINDS):.3f} ms in all, its prep "
          f"including {sum(v[0] for v in prep.values()) / 1e3:.3f} ms of PyTorch kernels "
          f"({sum(v[1] for v in prep.values())} launches)")
    # K7's parameter packing: host time of its ranges, device time of the
    # kernels launched inside them (counted in their kinds above)
    pack = range_kernels(prof, "K7 pack") if "K7 pack" in ranges else {}
    pack_host = [ev for ev in averages if ev.key == "K7 pack"
                 and ev.device_type == torch.autograd.DeviceType.CPU]
    k7_pack = {"host_ms": sum(ev.cpu_time_total for ev in pack_host) / 1e3,
               "calls": sum(ev.count for ev in pack_host),
               "device_ms": sum(v[0] for v in pack.values()) / 1e3,
               "device_launches": sum(v[1] for v in pack.values())}
    if k7_pack["calls"]:
        print(f"K7 parameter packing: host {k7_pack['host_ms']:.3f} ms over "
              f"{k7_pack['calls']} calls, device {k7_pack['device_ms']:.3f} ms over "
              f"{k7_pack['device_launches']} kernels (in their kinds)")
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {k:26s} {ms:9.3f} ms  {100 * ms / busy:5.1f}%  "
              f"{launches[k]} launches")
    ranked = sorted(kernels, key=lambda e: -device_us(e))[:top]
    for ev in ranked:
        print(f"    {device_us(ev) / 1e3:9.3f} ms x{ev.count:5d}  {ev.key[:90]}")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_launches": sum(launches.values()),
            "idle_share_profiled": 1 - busy / wall_ms,
            "idle_share_unprofiled": 1 - busy / host_ms,
            "by_kind_ms": kinds, "launches_by_kind": launches,
            "k1_prep_torch_kernels": prep, "k7_pack": k7_pack,
            # PyTorch's sort-based backward of advanced indexing, over every kernel
            "indexing_backward_ms": sum(device_us(ev) for ev in kernels
                                        if "indexing_backward" in ev.key) / 1e3,
            "top_kernels": [{"ms": device_us(ev) / 1e3, "count": ev.count,
                             "name": ev.key[:120]} for ev in ranked]}


def knn_calls(fn):
    """K1's calls in one run of ``fn``: {"kernel B=.. M=.. N=.. k=..": count}."""
    from pointcloudpdf_tpu_torch.ops import geometry

    calls = {}
    brute, pruned = geometry.knn_brute_cuda, geometry.knn_pruned_cuda

    def record(kind, launch):
        def call(query, ref, k, *args, **kwargs):
            key = (f"{kind} B={query.shape[0]} M={query.shape[1]} N={ref.shape[1]} "
                   f"k={k}")
            calls[key] = calls.get(key, 0) + 1
            return launch(query, ref, k, *args, **kwargs)
        return call

    geometry.knn_brute_cuda = record("brute", brute)
    geometry.knn_pruned_cuda = record("pruned", pruned)
    try:
        fn()
    finally:
        geometry.knn_brute_cuda, geometry.knn_pruned_cuda = brute, pruned
    for key, n in sorted(calls.items()):
        print(f"  K1 call {key}: {n}")
    return calls


def write_result(result, out):
    """The numbers as JSON into ``out`` (when given), the scalars on the
    last line of the output."""
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if not isinstance(v, (dict, list))}))


def serving_forward_profile(config, tester, recognizer, iters):
    """One serving forward of ``config`` through ``tester`` on the largest
    fragment of a synthetic S3DIS room (``chip_smoke.synthetic_room``), at
    full width on seeded random weights written through the bridge (with
    the recognizer's when ``recognizer``): milliseconds per forward on the
    kernels and on the plain versions (CUDA events and host clock; plain,
    kernels, kernels, plain), the launches of every kernel in one forward,
    the profile (``profile_call``) and peak device memory.  Prints them and
    returns them as a dict."""
    import tempfile

    import numpy as np
    import torch

    import chip_smoke
    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn
    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.test import TESTERS
    from pointcloudpdf_tpu_torch.models import build_model
    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.recognizers import build_recognizer

    result = {}
    with tempfile.TemporaryDirectory() as work:
        data_root = os.path.join(work, "s3dis")
        os.makedirs(os.path.join(data_root, "Area_5"))
        chip_smoke.synthetic_room(np.random.RandomState(0), os.path.join(
            data_root, "Area_5", "office_1.npz"))
        weight = os.path.join(work, "model.pth")
        cfg = default_config_parser(config, {
            "data_root": data_root, "data.test.data_root": data_root,
            "weight": weight, "save_path": os.path.join(work, "exp"),
            "device": "cuda"})
        torch.manual_seed(0)
        chip_smoke.random_jax_checkpoint(
            weight, build_model(dict(cfg.model)),
            build_recognizer(cfg.recognizer).model if recognizer else None)
        runner = TESTERS.build(dict(type=tester, cfg=cfg))
        fragments = runner.test_dataset[0]["fragment_list"]
        sizes = [len(f["coord"]) for f in fragments]
        fragment = fragments[int(np.argmax(sizes))]
        runner.forward_fragment(fragment)  # loads the weights, builds the kernels
        batch = runner.device_batch(padded_collate_fn([fragment]))
        result.update(fragment_points=max(sizes), bucket=batch["coord"].shape[1])
        print(f"fragment of {max(sizes)} points, bucket {batch['coord'].shape[1]}")

        def forward():
            with torch.inference_mode():
                runner.forward(batch)

        def timed(n):
            forward()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            for _ in range(n):
                forward()
            end.record()
            torch.cuda.synchronize()
            return (start.elapsed_time(end) / n,
                    (time.perf_counter() - t0) * 1e3 / n)

        # plain, kernels, kernels, plain: the two compared inside one call
        with _cuda.plain_versions():
            plain_a = timed(1)
        torch.cuda.reset_peak_memory_stats()
        kernel_a = timed(iters)
        result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        kernel_b = timed(iters)
        with _cuda.plain_versions():
            plain_b = timed(1)
        result.update(forward_ms_events=[kernel_a[0], kernel_b[0]],
                      forward_ms_host=[kernel_a[1], kernel_b[1]],
                      plain_forward_ms_events=[plain_a[0], plain_b[0]])
        print(f"forward on the kernels: {kernel_a[0]:.2f} / {kernel_b[0]:.2f} ms (CUDA "
              f"events), {kernel_a[1]:.2f} / {kernel_b[1]:.2f} ms (host clock, synced "
              f"at the end of {iters}); on the plain versions {plain_a[0]:.1f} / "
              f"{plain_b[0]:.1f} ms; peak memory {result['peak_memory_gib']:.2f} GiB")

        chip_smoke.reset_launches()
        result["knn_calls_a_forward"] = knn_calls(forward)
        counts = chip_smoke.read_launches()
        result["launches_a_forward"] = {k: v for k, v in counts.items()
                                        if not isinstance(v, tuple)}
        print(f"launches a forward: {result['launches_a_forward']}")

        result.update(profile_call(forward, kernel_b[1], "forward"))
    return result
