"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every ``csrc/*.cu`` file is compiled at first use, for ``sm_90a``, into
one shared library with a plain C interface under ``build/kernels/`` at
the root of the checkout.  The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsf_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently; raise with the stderr of those that
    failed, else return each one's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed, errs = [], []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def _report_path(lib: pathlib.Path) -> pathlib.Path:
    return lib.with_suffix(".ptxas.txt")


def build() -> pathlib.Path:
    """Compile the kernels if their library is missing; return its path.
    Each source compiles in its own nvcc, all at once, then one link.
    ptxas's report (registers, shared memory and spills of every kernel)
    is kept beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [s for s in _sources() if s.suffix == ".cu"]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    # build under temporary names, then rename: a concurrent or killed
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, s.stem + ".o") for s in cu]
        errs = _run_all([[_nvcc(), *compile_flags, "-Xptxas", "-v", "-c",
                          "-o", o, str(s)] for s, o in zip(cu, objs)])
        _report_path(out).write_text("".join(errs))
        tmp = os.path.join(tmpdir, out.name)
        _run_all([[_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, out)
    return out


def resource_report() -> str:
    """ptxas's lines for the built kernels: per kernel, its registers,
    shared memory, stack and spill bytes."""
    report = _report_path(build())
    if not report.exists():
        return "(no ptxas report beside this library)"
    text = report.read_text()
    return "\n".join(line.strip() for line in text.splitlines()
                     if "Compiling entry" in line or "Used" in line
                     or "spill" in line or "warning" in line.lower()
                     or "Performance" in line)


def spill_bytes() -> dict:
    """Per kernel of the built library, ptxas's spill stores plus spill
    loads in bytes (``Function properties for <kernel>`` and the line after
    it in the report)."""
    lines = _report_path(build()).read_text().splitlines()
    out = {}
    for i, line in enumerate(lines[:-1]):
        if "Function properties for" in line:
            words = lines[i + 1].replace(",", " ").split()
            out[line.split("for", 1)[1].strip()] = sum(
                int(words[j - 2]) for j, w in enumerate(words)
                if w == "spill" and j > 1)
    return out


SASS_OPCODES = ("HMMA", "HGMMA", "RED", "ATOM", "LDG")


def sass_counts() -> dict:
    """Per kernel of the built library, how many SASS instructions start
    with each of :data:`SASS_OPCODES` (``cuobjdump -sass``): shows that a
    kernel issues tensor-core instructions (HMMA, or HGMMA, the warpgroup
    products), reductions to global
    memory (RED, ATOM), and how many global loads (LDG) it has."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(build())],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPCODES, 0)
        elif fn is not None and line.startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):   # predicated
                words = words[1:]
            op = words[0] if words else ""
            for name in SASS_OPCODES:
                if op.startswith(name):
                    counts[fn][name] += 1
    return counts


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library once per
    process, with argtypes declared for every entry point (the span
    recorder's set-up span ``kernels/load``)."""
    from sparsefusion_tpu_torch.utils import spans

    with spans.setup_span("kernels/load"):
        lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("sf_grid_encode_fwd", "sf_grid_encode_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, i32, vp, i64, i32, i32, i32, vp, vp, vp, vp, vp]
        fn.restype = i32
    lib.sf_imagen_attention_fwd.argtypes = [vp] * 4 + [i32] * 4 + [vp]
    lib.sf_imagen_attention_fwd.restype = i32
    # ... plus the plan: body, rows per CTA, key tile, stages, shared bytes
    lib.sf_imagen_attention_fwd_bf16.argtypes = [vp] * 4 + [i32] * 9 + [vp]
    lib.sf_imagen_attention_fwd_bf16.restype = i32
    lib.sf_row_gather.argtypes = [vp, vp, vp, i64, i32, i32, vp]
    lib.sf_row_gather.restype = i32
    lib.sf_span_stamp.argtypes = [vp, vp, i64, i64, vp]
    lib.sf_span_stamp.restype = i32
    # x, w, bias, out; the shape (11 ints) and the plan (tile pixels and
    # channels, splits, weight tiles by TMA); the stream
    lib.sf_conv2d_splitk.argtypes = [vp] * 4 + [i32] * 15 + [vp]
    lib.sf_conv2d_splitk.restype = i32
    lib.sf_conv2d_splitk_max_clusters.argtypes = [i32]
    lib.sf_conv2d_splitk_max_clusters.restype = i32
    # x, w, bias, y; tokens, output and input features; the plan (tile
    # tokens and rows, splits, clusters); the stream
    lib.sf_linear_gemm.argtypes = [vp] * 4 + [i32] * 7 + [vp]
    lib.sf_linear_gemm.restype = i32
    return lib


def timed_build() -> float:
    """Build from scratch-or-cache and load; returns the seconds taken."""
    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0
