"""Build, load and dispatch the port's hand-written CUDA kernels.

The sources under ``pointcloudpdf_tpu_torch/csrc/`` compile with ``nvcc``
for ``sm_90a`` (Hopper) into one shared library with a plain C interface,
loaded with ``ctypes``.  The library is built at first use into
``pointcloudpdf_tpu_torch/_build/`` under a name keyed on a content hash of
the sources, so an edit rebuilds and an unchanged tree reuses the build.
Nothing here runs at import time: this module imports on a machine with no
CUDA toolkit, and the CPU path never calls it.

Every kernel wrapper dispatches on the device of its input:

- a CPU tensor goes to the kernel's plain PyTorch version;
- a CUDA tensor goes to the kernel, unless :func:`plain_versions` is
  active, which only ``chip_smoke.py`` and the tests enter, to hold a
  kernel against its plain version on the card;
- any other device raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()
_plain = False

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # query, ref, ref_mask, B, M, N, k, idx, dist2, stream
    "pcpdf_knn": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # query, ref, ref_mask, B, M, N, k, lanes (0: the rule), idx, dist2, stream
    "pcpdf_knn_brute": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # B, M -> the lanes a query of the brute-force kernel
    "pcpdf_knn_lanes": [_I, _I],
    # xyz, mask (or NULL), B, N, part, keys, n_valid (or NULL), stream
    "pcpdf_knn_codes": [_P, _P, _I, _I, _P, _P, _P, _P],
    # ref, ref_mask, order, B, N, R, sorted, boxes, sub_boxes, stream
    "pcpdf_knn_chunks": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # query, query_order, sorted, boxes, sub_boxes, n_valid, same, B, M, N,
    # k, R, idx, dist2, visits (or NULL), stream
    "pcpdf_knn_pruned": [_P] * 6 + [_I] * 6 + [_P] * 4,
    # xyz, mask, S, n, m, scratch, out, stream
    "pcpdf_fps": [_P, _P, _I, _I, _I, _P, _P, _P],
    # sorted, count, B, N, G, g, k_g, pos, stream
    "pcpdf_fps_windows": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    # xq, xk, xv, coord, idx, nmask, params, w1s, B, N, C, K, out, stream
    "pcpdf_vector_attention": [_P] * 8 + [_I] * 4 + [_P, _P],
    "pcpdf_vector_attention_params": [_I],
    # xq, xk, xv, coord, idx, nmask, params, dout, B, N, C, K,
    # dxq, dxk, dxv, dparams, stream
    "pcpdf_vector_attention_bwd": [_P] * 8 + [_I] * 4 + [_P] * 5,
    # q, k, v, coord, key_idx, key_mask, tq, tk, tv (each table or NULL),
    # scale, 2 * window, 1e-4, quant, B, N, C, K, num_bins, out, stream
    "pcpdf_st_attention": [_P] * 9 + [_F] * 4 + [_I] * 5 + [_P, _P],
    # coord, feat, idx, nmask, kp, weight, sigma_r, B, N, S, P, C_in, C_out,
    # out, stream
    "pcpdf_kpconv": [_P] * 6 + [_F] + [_I] * 6 + [_P, _P],
    # q, k, v, coord, idx, nmask, params, pm2, pb2, pe_mul, pe_bias, B, N, C,
    # S, out, stream
    "pcpdf_gva": [_P] * 9 + [_I] * 6 + [_P, _P],
    "pcpdf_gva_params": [_I],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    digest = hashlib.sha256()
    for path in _sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpcpdf_{digest.hexdigest()[:16]}.so")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels cannot be built")
    return nvcc


def build() -> str:
    """Compile the kernels if this source tree has no build yet; returns
    the library path.  One ``nvcc -c`` per source, all started together,
    then one link.  The compiler's register/spill report is kept beside
    the library as ``<name>.log``."""
    so = library_path()
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{so[:-3]}.{os.getpid()}"
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{stem}.{os.path.basename(src)[:-3]}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        report.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(report[-1])
    tmp = f"{stem}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        report.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(report[-1])
    for _, obj, _ in jobs:
        if os.path.isfile(obj):
            os.remove(obj)
    with open(so[:-3] + ".log", "w") as f:
        f.write("\n".join(report))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a kernel's C entry point reports a CUDA error (a refused
    launch never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return not _plain
    raise ValueError(f"no kernel or plain version for device {t.device}")


def expect_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check what a kernel takes: CUDA tensors, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if dev.type != "cuda" or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"{name}: inputs must be contiguous CUDA tensors on one "
                f"device, got {t.device}")


@contextlib.contextmanager
def plain_versions():
    """Run the kernels' plain PyTorch versions on CUDA tensors as well.

    For holding a kernel against its plain version on the card
    (``chip_smoke.py``, tests); never entered by the program itself."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev
