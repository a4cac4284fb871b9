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

The element-derivative kernels M-W (`egh_*.cu`) build with `-fmad=false`:
their value-only and derivative forms must round the energy alike, bit for
bit. Their element math also builds as plain C++17 with g++
(`host_library`, CPU only, for the tests and for the operation counts
`chip_smoke.py` prices a bound with), and so does kernel I
(`host_pairs_library`, its tiles' lanes in turn, for its CPU test and the
exact-distance share `chip_smoke.py` prints) and kernels F and L
(`host_broad_library`, for their CPU test). Kernel Y (`pcg_step.cu`)
builds with `-fmad=false` too, so that its vector updates round as its
plain version's; it and kernel X (`graph_ctl.cu`, the CUDA-graph loop
control) are left out of the g++ build.

`launches` counts kernel launches by kernel entry point (and, for the
segmented reduce, the compaction and kernels M-W, by call site: M-W per
family, `egh_strain[strain]` for e, g and H, `egh_strain[strain:e]` for the
value only). Each wrapper adds one right after its kernel launched and
nowhere else, so a run can show that the main path went through the
kernels. `func_on_card` counts, by family, the evaluations on CUDA tensors
that go through torch.func: a family without a kernel (every family has
one; the smoke asserts the count stays empty).
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
# sources whose value-only and derivative forms must round alike (and kernel
# Y, whose axpys round as its plain version's); the g++ host build takes the
# egh_ sources alone. STARK_TPU_TORCH_NO_FMA (source names, comma-separated)
# adds sources, to measure what contraction changes (ROADMAP Queue 3 item 2)
NO_FMA_PREFIX = "egh_"
NO_FMA_SOURCES = ("pcg_step.cu",) + tuple(
    s for s in os.environ.get("STARK_TPU_TORCH_NO_FMA", "").split(",") if s)
NO_FMA_FLAGS = ["-fmad=false"]
# sources compiled as several objects, one nvcc process each, all started
# with the others: egh_contact.cu's 14 dual kernels took 205 s as one
# process; per kind (PT, EE) and dtype each part builds a quarter of them
# (egh_friction.cu, kernel Q, and egh_joints.cu, T and U, are split the same
# way)
_EGH_PARTS = [["-DSTK_EGH_PART=%d" % k, "-DSTK_EGH_ONLY_%s" % d]
              for k in (0, 1) for d in ("F32", "F64")]
PARTS = {"egh_contact.cu": _EGH_PARTS, "egh_friction.cu": _EGH_PARTS,
         "egh_joints.cu": _EGH_PARTS}
HOST_FLAGS = ["-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
              "-x", "c++"]

launches: collections.Counter = collections.Counter()
func_on_card: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_host_lib: Optional[ctypes.CDLL] = None
_host_pairs_lib: Optional[ctypes.CDLL] = None
_host_broad_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

# (argtypes) of every exported entry point; each exists as _f32 and _f64
_SIGNATURES = {
    "stk_segment_reduce": [_P, _I, _P, _P, _I, _P, _P],
    "stk_direct_dense": [_P, _P, _P, _I, _I, _P, _P],
    # kernel B: host arrays of the groups' H, conn, arity, perm and offsets
    "stk_hvp_bucket": [_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P],
    "stk_pd_project": [_P, _I, _I, _P, _I, _I, _D, _I, _P, _P, _P, _P],
    "stk_pd_project_z": [_P, _I, _I, _P, _P, _I, _I, _I, _D, _I, _P, _P, _P, _P, _P, _P,
                         _P],
    "stk_block3_inverse": [_P, _I, _D, _P, _P],
    # kernels AB and AC (the gather-table hvp and the dense run sums)
    "stk_hvp_table": [_P, _P, _I, _P, _I, _P, _I, _I, _P, _P],
    "stk_dense_runs": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "stk_block3_apply": [_P, _P, _I, _P, _P],
    "stk_pt_distance": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "stk_ee_distance": [_P, _P, _P, _P, _I, _D, _P, _P, _P, _P, _P],
    "stk_segment_triangle_any": [_P, _P, _P, _P, _P, _I, _P, _D, _P, _P, _P],
    "stk_friction_rows_pt": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                             _P, _P, _P, _P, _P, _P],
    "stk_friction_rows_ee": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _D,
                             _P, _P, _P, _P, _P, _P],
    "stk_grid_build": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    # kernel K with a CUDA event recorded between its steps (the split timing)
    "stk_grid_build_split": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
}
# kernels F and L (the last argument the stream; the g++ build's stk_host_
# forms take none)
BROAD_SIGNATURES = {
    "stk_ball_wide": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P],
    "stk_rowk_select": [_I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P,
                        _P, _I, _P, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P],
}
_SIGNATURES.update(BROAD_SIGNATURES)
# kernel I (the last argument the stream; the g++ build's stk_host_ forms
# take, in its place, the cull switch and a pointer to the exact-test count)
PAIR_SIGNATURES = {
    "stk_friction_pairs_pt": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                              _P, _P, _P, _P, _P],
    "stk_friction_pairs_ee": [_P, _P, _I, _P, _P, _P, _P, _I, _D, _I, _P, _P, _P,
                              _P, _P, _P, _P],
    "stk_contact_pairs_pt": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                             _P, _P],
    "stk_contact_pairs_ee": [_P, _P, _I, _P, _P, _P, _D, _I, _P, _P, _P, _P, _P, _P,
                             _P],
}
_SIGNATURES.update(PAIR_SIGNATURES)
# scratch sizes (bytes or ints) that a launcher computes from its shapes
_SIZES = {"stk_pair_lists_scratch_bytes": [_I, _I, _I, _I],
          "stk_grid_build_scratch_ints": [_I, _I, _I],
          "stk_ball_wide_scratch_ints": [_I, _I],
          "stk_rowk_select_scratch_ints": [_I, _I]}
# kernels M-W: one entry point per family, (ptrs, scalars, E, e, g, H, stream)
EGH_FAMILIES = ("strain", "strain_eo", "lumped", "prescribed", "shells_flat",
                "rb_linear", "rb_angular", "global_points", "global_directions",
                "pt_dd", "pt_dr", "pt_rd", "pt_rr", "ee_dd", "ee_dr", "ee_rr",
                "segment", "segment_eo", "tet", "tet_eo",
                "friction_pt_dd", "friction_pt_dr", "friction_pt_rd", "friction_pt_rr",
                "friction_ee_dd", "friction_ee_dr", "friction_ee_rr",
                "points", "point_on_axis", "distances", "distance_limits", "damped_spring",
                "directions", "angle_limits", "linear_velocity", "angular_velocity",
                "shells", "att_pp", "att_pe", "att_pt", "att_ee", "att_rbd")
_EGH_ARGS = [_P, _P, _L, _P, _P, _P, _P]
_SIGNATURES.update({"stk_egh_" + f: _EGH_ARGS for f in EGH_FAMILIES})
# kernel Y: the two halves of a PCG step
_SIGNATURES.update({"stk_pcg_step1": [_P, _P, _P, _P, _P, _P, _L, _I, _D, _P],
                    "stk_pcg_step2": [_P, _P, _P, _P, _P, _L, _I, _P]})
# entry points without a floating-point operand: one symbol, no suffix
_UNTYPED = {
    "stk_compact": [_P, _L, _I, _P, _P, _P, _P],
    # kernel AA: the gather tables
    "stk_gather_table": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "stk_gather_hot": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    "stk_pair_keys": [_P, _L, _I, _I, _P, _P],
    "stk_run_heads": [_P, _I, _P, _P],
    "stk_slot_pids": [_P, _P, _P, _I, _I, _P, _P],
    # kernel X: the conditional-node setter and the body captures
    "stk_graph_set_cond": [ctypes.c_ulonglong, _P, _P],
    "stk_graph_begin_body": [_P, _P, _I, _P, ctypes.POINTER(ctypes.c_ulonglong)],
    "stk_graph_end_body": [_P],
}


def reset_launches():
    launches.clear()
    func_on_card.clear()


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


def _flags(src: str) -> list:
    base = os.path.basename(src)
    no_fma = base.startswith(NO_FMA_PREFIX) or base in NO_FMA_SOURCES
    return NVCC_FLAGS + (NO_FMA_FLAGS if no_fma else [])


def _digest(files, flags=None) -> str:
    flags = ARCH_FLAGS + NVCC_FLAGS + NO_FMA_FLAGS + [str(PARTS), str(NO_FMA_SOURCES)] \
        if flags is None else flags
    h = hashlib.sha256(" ".join(flags).encode())
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
            base = os.path.basename(src)
            parts = PARTS.get(base, [[]])
            for i, extra in enumerate(parts):
                name = base if len(parts) == 1 else f"{base}[{i}]"
                obj = os.path.join(tmp, f"{base}.{i}.o")
                cmd = [nvcc, *ARCH_FLAGS, *_flags(src), *extra, "-c", src, "-o", obj]
                procs.append((name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs = {}
        seconds = {}

        def wait(name, p):
            out, _ = p.communicate()
            logs[name] = out.decode(errors="replace")
            seconds[name] = time.perf_counter() - t0

        waiters = [threading.Thread(target=wait, args=(n, p)) for n, _o, p in procs]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        failed = [n for n, _o, p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed for %s:\n%s" % (
                ", ".join(failed), "\n".join(logs[n] for n in failed)))
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
            "seconds_by_source": seconds,
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
        for name, args in _SIZES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_longlong
        info["path"] = lib_path
        build_info.clear()
        build_info.update(info)
        _lib = lib
        return _lib


def _host_build(srcs, stem: str) -> str:
    """Compile `srcs` with g++ (one process each) into
    build/lib<stem>_<hash>.so, unless it is there; returns its path."""
    _cu, hdr = _sources()
    lib_path = os.path.join(BUILD_DIR, "lib%s_%s.so" % (stem, _digest(srcs + hdr,
                                                                       HOST_FLAGS)))
    if os.path.exists(lib_path):
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host builds of the kernels need a "
                           "C++17 compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [gxx, *[f for f in HOST_FLAGS if f != "-shared"], "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        for src, _obj, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError("g++ failed for %s:\n%s" % (src, out.decode(errors="replace")))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([gxx, "-shared", "-o", tmp_lib, *[o for _s, o, _p in procs]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("g++ link failed:\n" + link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib_path)
    return lib_path


def host_library() -> ctypes.CDLL:
    """The element math of kernels M-W built as plain C++17 with g++ (one
    process per source, linked into build/libstark_egh_host_<hash>.so):
    entry points stk_host_egh_<family>_f32/_f64 (ptrs, scalars, E, e, g, H)
    that loop over the rows on the CPU."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    with _lock:
        if _host_lib is not None:
            return _host_lib
        cu, _hdr = _sources()
        srcs = [s for s in cu if os.path.basename(s).startswith(NO_FMA_PREFIX)]
        lib = ctypes.CDLL(_host_build(srcs, "stark_egh_host"))
        for f in EGH_FAMILIES:
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, "stk_host_egh_" + f + suffix)
                fn.argtypes = _EGH_ARGS[:-1]
                fn.restype = ctypes.c_int
        _host_lib = lib
        return _host_lib


def host_pairs_library() -> ctypes.CDLL:
    """Kernel I (csrc/friction_pairs.cu) built as plain C++17 with g++ into
    build/libstark_pairs_host_<hash>.so: entry points stk_host_<mode>_pairs_
    <kind>_f32/_f64 with the card's arguments, the stream replaced by the
    cull switch (int) and the exact-test count (int*), which run the tiles'
    lanes in turn on the CPU."""
    global _host_pairs_lib
    if _host_pairs_lib is not None:
        return _host_pairs_lib
    with _lock:
        if _host_pairs_lib is not None:
            return _host_pairs_lib
        lib = ctypes.CDLL(_host_build([os.path.join(CSRC, "friction_pairs.cu")],
                                      "stark_pairs_host"))
        for name, args in PAIR_SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name.replace("stk_", "stk_host_", 1) + suffix)
                fn.argtypes = args[:-1] + [_I, _P]
                fn.restype = ctypes.c_int
        fn = lib.stk_pair_lists_scratch_bytes
        fn.argtypes = _SIZES["stk_pair_lists_scratch_bytes"]
        fn.restype = ctypes.c_longlong
        _host_pairs_lib = lib
        return _host_pairs_lib


def host_broad_library() -> ctypes.CDLL:
    """Kernels F and L (csrc/ball_wide.cu, csrc/rowk_select.cu) built as
    plain C++17 with g++ into build/libstark_broad_host_<hash>.so: entry
    points stk_host_ball_wide_f32/_f64 and stk_host_rowk_select_f32/_f64
    with the card's arguments but the stream, which run the tiles, the
    grouping and the walks with each round's lanes in turn on the CPU."""
    global _host_broad_lib
    if _host_broad_lib is not None:
        return _host_broad_lib
    with _lock:
        if _host_broad_lib is not None:
            return _host_broad_lib
        lib = ctypes.CDLL(_host_build([os.path.join(CSRC, "ball_wide.cu"),
                                       os.path.join(CSRC, "rowk_select.cu")],
                                      "stark_broad_host"))
        for name, args in BROAD_SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name.replace("stk_", "stk_host_", 1) + suffix)
                fn.argtypes = args[:-1]
                fn.restype = ctypes.c_int
        for name in ("stk_ball_wide_scratch_ints", "stk_rowk_select_scratch_ints"):
            fn = getattr(lib, name)
            fn.argtypes = _SIZES[name]
            fn.restype = ctypes.c_longlong
        _host_broad_lib = lib
        return _host_broad_lib


def host_broad_entry(name: str, dtype: Optional[torch.dtype] = None):
    """The host build's counterpart of entry(name, dtype) for kernels F and L."""
    lib = host_broad_library()
    if dtype is None:
        return getattr(lib, name)
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    return getattr(lib, name.replace("stk_", "stk_host_", 1) + suffix)


def host_pairs_entry(name: str, dtype: Optional[torch.dtype] = None):
    """The host build's counterpart of entry(name, dtype) for kernel I."""
    lib = host_pairs_library()
    if dtype is None:
        return getattr(lib, name)
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    return getattr(lib, name.replace("stk_", "stk_host_", 1) + suffix)


def host_entry(name: str, dtype: torch.dtype):
    """The host build's counterpart of entry(name, dtype) for kernels M-W."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    return getattr(host_library(), name.replace("stk_", "stk_host_", 1) + suffix)


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
