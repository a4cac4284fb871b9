"""Build, load and count the CUDA kernels of `stark_tpu_torch/csrc/`.

The kernels are CUDA C++ with a plain C interface. At first use every
`csrc/*.cu` is compiled by its own `nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -Xcompiler -fPIC` process, all started together, and the objects are
linked into one shared library under `build/` at the repository root (listed
in `.gitignore`), named by a hash of the sources so a changed source is never
served a stale build. The library is loaded with ctypes; pointers and the
stream travel as `c_void_p`.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc or a card.

`launches` counts kernel launches by kernel entry point (and, for the
segmented reduce and the compaction, by call site). Each wrapper adds one right after its
kernel launched and nowhere else, so a run can show that the main path went
through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

# (argtypes) of every exported entry point; each exists as _f32 and _f64
_SIGNATURES = {
    "stk_segment_reduce": [_P, _I, _P, _P, _I, _P, _P],
    "stk_hvp_bucket": [_P, _P, _I, _P, _I, _P, _P, _P, _P],
    "stk_pd_project": [_P, _I, _I, _P, _I, _I, _D, _I, _P, _P, _P, _P],
    "stk_block3_inverse": [_P, _I, _D, _P, _P],
    "stk_block3_apply": [_P, _P, _I, _P, _P],
    "stk_ball_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P,
                      _P, _P],
    "stk_pt_distance": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "stk_ee_distance": [_P, _P, _P, _P, _I, _D, _P, _P, _P, _P, _P],
    "stk_segment_triangle_any": [_P, _P, _P, _P, _P, _I, _P, _D, _P, _P, _P],
    "stk_friction_pairs_pt": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                              _P, _P, _P, _P, _P],
    "stk_friction_pairs_ee": [_P, _P, _I, _P, _P, _P, _P, _I, _D, _I, _P, _P, _P,
                              _P, _P, _P, _P],
    "stk_contact_pairs_pt": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                             _P, _P],
    "stk_contact_pairs_ee": [_P, _P, _I, _P, _P, _P, _D, _I, _P, _P, _P, _P, _P, _P,
                             _P],
    "stk_friction_rows_pt": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                             _P, _P, _P, _P, _P, _P],
    "stk_friction_rows_ee": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _D,
                             _P, _P, _P, _P, _P, _P],
    "stk_grid_build": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "stk_rowk_select": [_I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P,
                        _P, _I, _P, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P],
}
# entry points without a floating-point operand: one symbol, no suffix
_UNTYPED = {
    "stk_compact": [_P, _L, _I, _P, _P, _P, _P],
}


def reset_launches():
    launches.clear()


def count_launch(name: str):
    launches[name] += 1


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of stark_tpu_torch "
                       "are built with nvcc at first use on a CUDA machine")


def _sources():
    names = sorted(os.listdir(CSRC))
    cu = [os.path.join(CSRC, n) for n in names if n.endswith(".cu")]
    hdr = [os.path.join(CSRC, n) for n in names if n.endswith(".cuh")]
    return cu, hdr


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _compile(lib_path: str) -> dict:
    """Compile every source in parallel, link, and move the library into
    place atomically. Returns the build record (seconds, ptxas output)."""
    nvcc = _nvcc()
    cu, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in cu:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs = {}
        failed = []
        for src, _obj, p in procs:
            out, _ = p.communicate()
            logs[os.path.basename(src)] = out.decode(errors="replace")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed for %s:\n%s" % (
                ", ".join(failed),
                "\n".join(logs[os.path.basename(f)] for f in failed)))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
             *[o for _s, o, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(
                errors="replace"))
        os.replace(tmp_lib, lib_path)
    return {"seconds": time.perf_counter() - t0, "ptxas": logs,
            "sources": [os.path.basename(s) for s in cu], "built": True}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        cu, hdr = _sources()
        lib_path = os.path.join(BUILD_DIR,
                                "libstark_kernels_%s.so" % _digest(cu + hdr))
        if os.path.exists(lib_path):
            info = {"seconds": 0.0, "ptxas": {}, "built": False,
                    "sources": [os.path.basename(s) for s in cu]}
        else:
            info = _compile(lib_path)
        lib = ctypes.CDLL(lib_path)
        for name, args in _SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = args
                fn.restype = ctypes.c_int
        for name, args in _UNTYPED.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        info["path"] = lib_path
        build_info.clear()
        build_info.update(info)
        _lib = lib
        return _lib


def entry(name: str, dtype: Optional[torch.dtype] = None):
    """The C entry point `name` for `dtype` (float32 or float64); None for
    the entry points that take no floating-point operand."""
    if dtype is None:
        return getattr(library(), name)
    if dtype == torch.float32:
        return getattr(library(), name + "_f32")
    if dtype == torch.float64:
        return getattr(library(), name + "_f64")
    raise TypeError(f"{name}: unsupported dtype {dtype}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_status(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require_cuda(name: str, *tensors: torch.Tensor):
    """Validate that every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
