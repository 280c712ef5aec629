"""K2 on one GPU: an earlier tree's FPS kernel beside this tree's, at the
blocked window shapes of ``chip_smoke.py`` phase 3.

    python3 tools/fps_compare_torch.py --parent DIR [--out FILE]

``--parent DIR``: a tree holding ``pointcloudpdf_tpu_torch/csrc/`` (the
parent commit unpacked with ``git archive`` into a git-ignored directory,
say).  Its ``fps.cu`` is built alone with nvcc into ``DIR/_fps_build/``.
At every case of ``chip_smoke.FPS_WINDOW_CASES`` (B = 2; PT-v1's windows of
256 points x 64 picks, ST's 512 x 128 and 1,024 x 128):

- the kernels alone, from a CUDA graph of calls (``chip_smoke.graph_ms``),
  in turns (parent, this tree, this tree, parent): the parent's
  ``pcpdf_fps`` on the gathered windows, this tree's ``pcpdf_fps_windows``
  on the sorted samples, which it reads in place; the plain version once;
- the whole blocked call before and after: the parent's window arithmetic,
  gathers and kernel (its ``blocked_farthest_point_sampling``, rebuilt
  here around the parent's kernel) against this tree's
  ``blocked_farthest_point_sampling``, in turns, by CUDA events, with the
  device kernels each launches (``torch.profiler``);
- one window alone (B = 1, G = 1), whose time over its rounds is this
  kernel's latency a round.

It also measures the latency of one warp-wide argmax as the windows kernel
forms it (a redux.sync max of the key, a redux.sync min of the slot),
chained, in SM cycles (clock64), and the SM clock (cycles over CUDA-event
time of a spin), and prints the dependent-rounds floor of each case:
(k_g - 1) rounds x that latency.  The picks of the two kernels, and of the
two blocked calls, are held equal; the tool exits non-zero where they
differ.  ``--out`` writes the numbers as JSON, with the card's
``nvidia-smi`` name and power limit.  Needs a CUDA device and nvcc.
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

PROBE = r"""
// the windows kernel's argmax, chained: cycles a step
extern "C" __global__ void argmax_chain(unsigned* out, long long* cycles, int steps) {
  unsigned key = threadIdx.x * 2654435761u, idx = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    const unsigned slot = __reduce_min_sync(0xffffffffu, key == top ? idx : 0xffffffffu);
    key ^= slot;
  }
  const long long t1 = clock64();
  out[threadIdx.x] = key;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// a spin of a given number of cycles, to read the SM clock by events
extern "C" __global__ void spin(long long n, long long* sink) {
  const long long t0 = clock64();
  while (clock64() - t0 < n) {}
  if (threadIdx.x == 0) sink[0] = clock64() - t0;
}

extern "C" int argmax_cycles(void* out, void* cycles, int steps) {
  argmax_chain<<<1, 32>>>(static_cast<unsigned*>(out), static_cast<long long*>(cycles), steps);
  return (int)cudaGetLastError();
}

extern "C" int spin_cycles(long long n, void* sink) {
  spin<<<1, 32>>>(n, static_cast<long long*>(sink));
  return (int)cudaGetLastError();
}
"""


def nvcc_shared(src, so, text=None):
    from pointcloudpdf_tpu_torch.ops import _cuda

    if text is not None:
        with open(src, "w") as f:
            f.write(text)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n" + proc.stdout + proc.stderr)
    return ctypes.CDLL(so)


def build_parent(tree):
    """nvcc the tree's fps.cu alone (same flags as the port's build)."""
    from pointcloudpdf_tpu_torch.ops import _cuda

    out_dir = os.path.join(tree, "_fps_build")
    os.makedirs(out_dir, exist_ok=True)
    lib = nvcc_shared(os.path.join(tree, "pointcloudpdf_tpu_torch", "csrc", "fps.cu"),
                      os.path.join(out_dir, "libfps_parent.so"))
    fn = lib.pcpdf_fps
    fn.argtypes = _cuda._SIGNATURES["pcpdf_fps"]
    fn.restype = ctypes.c_int
    return fn


def argmax_latency():
    """(cycles of one chained argmax, SM cycles a millisecond)."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda

    out_dir = os.path.join(_cuda.BUILD_DIR, "fps_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = nvcc_shared(os.path.join(out_dir, "probe.cu"), os.path.join(out_dir, "libprobe.so"),
                      PROBE)
    lib.argmax_cycles.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.spin_cycles.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    out = torch.empty(32, dtype=torch.int32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    per_step = []
    for steps in (1000, 9000):
        _cuda.check(lib.argmax_cycles(out.data_ptr(), cycles.data_ptr(), steps), "argmax")
        torch.cuda.synchronize()
        per_step.append(int(cycles.item()))
    step_cycles = (per_step[1] - per_step[0]) / 8000
    n = 50_000_000
    _cuda.check(lib.spin_cycles(n, cycles.data_ptr()), "spin")  # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _cuda.check(lib.spin_cycles(n, cycles.data_ptr()), "spin")
    end.record()
    torch.cuda.synchronize()
    return step_cycles, float(cycles.item()) / start.elapsed_time(end)


def parent_blocked(fn, coord, m, mask, steps):
    """The parent tree's blocked_farthest_point_sampling (G > 1): the window
    rows and validity built, the windows gathered, the parent's kernel on
    them, the picks mapped back."""
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda, sampling

    B, N, _ = coord.shape
    G, g, k_g = sampling.window_shape(N, m, None, steps)
    order = sampling.morton_sort_indices(coord, mask)
    sorted_coord = coord.gather(1, order[..., None].expand(B, N, 3))
    window, local_valid = sampling._window_rows(mask.sum(dim=1), G, g, N)
    coord_g = sorted_coord.gather(1, window.reshape(B, G * g, 1).expand(B, G * g, 3))
    xyz = coord_g.reshape(B * G, g, 3).contiguous()
    vmask = local_valid.reshape(B * G, g).contiguous()
    picks = torch.empty((B * G, k_g), dtype=torch.int32, device=coord.device)
    _cuda.check(fn(xyz.data_ptr(), vmask.data_ptr(), B * G, g, k_g, None, picks.data_ptr(),
                   ctypes.c_void_p(_cuda.stream_of(xyz))), "parent pcpdf_fps")
    pos = window.gather(2, picks.long().reshape(B, G, k_g)).reshape(B, m)
    idx = order.gather(1, pos)
    valid = mask.gather(1, idx)
    return idx, valid & ~sampling._flag_duplicates(pos)


def device_launches(fn):
    """Kernels one call of ``fn`` puts on the device (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    return len(names), names


def compare(parent_fn, rng, step_cycles, cycles_per_ms):
    import torch

    from pointcloudpdf_tpu_torch.ops import _cuda, sampling

    dev = torch.device("cuda")
    rows, same = [], True
    B = 2
    for i, (name, N, m, steps) in enumerate(chip_smoke.FPS_WINDOW_CASES):
        G, g, k_g = sampling.window_shape(N, m, None, steps)
        coord, mask = chip_smoke.clustered_cloud(
            rng if i == 0 else np.random.RandomState(chip_smoke.SEED + i), B, N, [N, N - N // 7])
        coord, mask = torch.from_numpy(coord).to(dev), torch.from_numpy(mask).to(dev)
        order = sampling.morton_sort_indices(coord, mask)
        sorted_coord = coord.gather(1, order[..., None].expand(B, N, 3)).contiguous()
        count = mask.sum(1, dtype=torch.int32)
        window, local_valid = sampling._window_rows(count, G, g, N)
        xyz = sorted_coord.gather(
            1, window.reshape(B, G * g, 1).expand(B, G * g, 3)).reshape(B * G, g, 3).contiguous()
        vmask = local_valid.reshape(B * G, g).contiguous()
        picks = torch.empty((B * G, k_g), dtype=torch.int32, device=dev)
        pos = torch.empty((B, G * k_g), dtype=torch.int64, device=dev)
        lib = _cuda.library()

        def old_run():
            _cuda.check(parent_fn(xyz.data_ptr(), vmask.data_ptr(), B * G, g, k_g, None,
                                  picks.data_ptr(), ctypes.c_void_p(_cuda.stream_of(xyz))),
                        "parent pcpdf_fps")

        def new_run():
            _cuda.check(lib.pcpdf_fps_windows(sorted_coord.data_ptr(), count.data_ptr(), B, N,
                                              G, g, k_g, pos.data_ptr(),
                                              ctypes.c_void_p(_cuda.stream_of(sorted_coord))),
                        "pcpdf_fps_windows")

        old_run()
        new_run()
        torch.cuda.synchronize()
        old_pos = window.gather(2, picks.long().reshape(B, G, k_g)).reshape(B, G * k_g)
        equal = torch.equal(old_pos, pos)
        times = [chip_smoke.graph_ms(f, 10) for f in (old_run, new_run, new_run, old_run)]
        with _cuda.plain_versions():
            plain_ms = chip_smoke.cuda_ms(
                lambda: sampling.fps_windows(sorted_coord, count, G, g, k_g), 2)

        def old_blocked():
            return parent_blocked(parent_fn, coord, m, mask, steps)

        def new_blocked():
            return sampling.blocked_farthest_point_sampling(coord, m, mask,
                                                            max_group_steps=steps)

        a, b = old_blocked(), new_blocked()
        equal = equal and all(torch.equal(x, y) for x, y in zip(a, b))
        same = same and equal
        blocked = [chip_smoke.cuda_ms(f, 20)
                   for f in (old_blocked, new_blocked, new_blocked, old_blocked)]
        old_launches, old_names = device_launches(old_blocked)
        new_launches, new_names = device_launches(new_blocked)

        # one window alone: the kernel's latency a round
        one = sorted_coord[:1, :g].contiguous()
        one_count = torch.full((1,), g, dtype=torch.int32, device=dev)
        one_pos = torch.empty((1, k_g), dtype=torch.int64, device=dev)

        def one_run():
            _cuda.check(lib.pcpdf_fps_windows(one.data_ptr(), one_count.data_ptr(), 1, g, 1, g,
                                              k_g, one_pos.data_ptr(),
                                              ctypes.c_void_p(_cuda.stream_of(one))),
                        "pcpdf_fps_windows")

        one_ms = chip_smoke.graph_ms(one_run, 20)
        n_flops = B * G * g * k_g * 10
        n_bytes = B * N * 12 + B * 4 + B * m * 8
        bound_ms, bound_by = chip_smoke.bound(n_bytes, n_flops)
        floor_ms = (k_g - 1) * step_cycles / cycles_per_ms
        case = f"{name}: {B * G} windows of {g} x {k_g}"
        rows.append({"case": case, "N": N, "m": m, "G": G, "g": g, "k_g": k_g,
                     "parent_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "rounds_floor_ms": floor_ms, "one_window_ms": one_ms,
                     "one_window_cycles_a_round": one_ms * cycles_per_ms / (k_g - 1),
                     "blocked_parent_ms": [blocked[0], blocked[3]],
                     "blocked_new_ms": [blocked[1], blocked[2]],
                     "blocked_parent_launches": old_launches,
                     "blocked_new_launches": new_launches,
                     "blocked_new_kernels": new_names, "equal": equal})
        speedup = (times[0] + times[3]) / (times[1] + times[2])
        print(f"{case:44s} parent {times[0]:.4f} / {times[3]:.4f} ms   new {times[1]:.4f} / "
              f"{times[2]:.4f} ms   x{speedup:.2f}   plain {plain_ms:.3f}   bound "
              f"{bound_ms:.5f} ({bound_by})   rounds floor {floor_ms:.5f}   one window "
              f"{one_ms:.4f} ms ({one_ms * cycles_per_ms / (k_g - 1):.0f} cycles a round)   "
              f"equal {equal}", flush=True)
        print(f"{'':44s} blocked call: parent {blocked[0]:.3f} / {blocked[3]:.3f} ms, "
              f"{old_launches} kernels; new {blocked[1]:.3f} / {blocked[2]:.3f} ms, "
              f"{new_launches} kernels", flush=True)
        del coord, mask, sorted_coord, xyz
        torch.cuda.empty_cache()
    return rows, same


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
    step_cycles, cycles_per_ms = argmax_latency()
    print(f"one chained warp argmax (2 x redux.sync): {step_cycles:.1f} cycles; SM clock "
          f"{cycles_per_ms / 1e3:.1f} MHz")
    rows, same = compare(build_parent(args.parent), np.random.RandomState(chip_smoke.SEED),
                         step_cycles, cycles_per_ms)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "argmax_cycles": step_cycles,
                       "sm_cycles_per_ms": cycles_per_ms, "rows": rows}, f, indent=1)
    print(card)
    if not same:
        raise SystemExit("the parent's picks and this tree's differ")


if __name__ == "__main__":
    main()
