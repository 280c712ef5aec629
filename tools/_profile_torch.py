"""What the port's profiling tools share: the card's name line, the split of
one profiled call's device time by kind of kernel, and the JSON record.

Used by ``tools/profile_train_torch.py`` and ``tools/profile_st_torch.py``;
each builds its own batch and the closure to profile.
"""

import json
import os
import subprocess
import time

# a kernel's kind is the first whose keys its name holds
KINDS = (
    ("K1 kNN", ("knn_kernel",)),
    ("K2 FPS", ("fps_",)),
    ("K4 backward", ("attn_bwd_kernel",)),
    ("K5 window attention", ("st_attention_kernel",)),
    ("K4 forward / K3", ("attn_kernel",)),
    ("K6 KPConv", ("kpconv_kernel",)),
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
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and device_us(ev) > 0]
    for ev in kernels:
        k = kind_of(ev.key)
        kinds[k] = kinds.get(k, 0.0) + device_us(ev) / 1e3
        launches[k] = launches.get(k, 0) + ev.count
    busy = sum(kinds.values())
    print(f"profiled {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms over "
          f"{sum(launches.values())} kernels, idle share {1 - busy / wall_ms:.3f} "
          f"(profiled), {1 - busy / host_ms:.3f} against the unprofiled host clock")
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
            "top_kernels": [{"ms": device_us(ev) / 1e3, "count": ev.count,
                             "name": ev.key[:120]} for ev in ranked]}


def write_result(result, out):
    """The numbers as JSON into ``out`` (when given), the scalars on the
    last line of the output."""
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if not isinstance(v, (dict, list))}))
