"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into an object file (one ``nvcc`` per source, all started
together; the ``*.cuh`` headers there are included by relative path), and
the objects are linked into one shared library with a plain C interface,
``build/kernels/librepro_torch_kernels.so`` at the root of the checkout.
The library is loaded with ``ctypes``.  Nothing here runs when a module is
imported: :func:`load_library` builds at the first launch and reuses the
library while the sources, headers and flags stay the same (a stamp of
their hash sits beside it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: pointers and the stream as c_void_p, ints as c_int,
# floats as c_float; each
# returns cudaGetLastError() right after its launch
SIGNATURES = {
    # q, k, v, out, lse (null: not written), B, Sq, Sk, H, Hkv, dh, causal,
    # has_window, window, q_offset, is_bf16, stream
    "repro_flash_attention": [_P] * 5 + [_I] * 11 + [_P],
    # q, k, v, pos, cur, part_acc, part_ml, out, ml_out (null: not
    # written), B, C, H, Hkv, dh, n_split, split_len, has_window, window,
    # is_bf16, stream
    "repro_decode_attention": [_P] * 9 + [_I] * 10 + [_P],
    # q, k_pool, v_pool, table, cur, part_acc, part_ml, out, B, H, Hkv, dh,
    # n_pages, page_size, max_pages, n_split, pages_per_split, is_bf16,
    # stream
    "repro_paged_decode_attention": [_P] * 8 + [_I] * 10 + [_P],
    # q, k_pool, v_pool, table, cur, part_acc, part_ml, out, B, W, H, Hkv,
    # dh, n_pages, page_size, max_pages, n_split, pages_per_split, is_bf16,
    # stream
    "repro_paged_verify_attention": [_P] * 8 + [_I] * 11 + [_P],
    # q, pk, pv, k, v, out, B, Sq, Lp, Sk, H, Hkv, dh, q_offset, is_bf16,
    # stream
    "repro_prefix_flash_attention": [_P] * 6 + [_I] * 9 + [_P],
    # x, dt, A, Bm, Cm, y, state, the bf16 passes' scratch (cum, dt, C.B^T,
    # chunk states, entering states), B, nh, S, hd, G, N, chunk, is_bf16,
    # then the batch and sequence strides of x, dt, Bm and Cm, stream
    "repro_ssd_scan": [_P] * 12 + [_I] * 16 + [_P],
    # x, scale, y, T, d, eps, x_is_bf16, scale_is_bf16, route (1 rows in
    # registers, 0 two passes), stream
    "repro_rmsnorm": [_P] * 3 + [_I] * 2 + [_F] + [_I] * 3 + [_P],
    # a, b, c, M, N, K, in_is_bf16, out_is_bf16, route (1 wgmma, 0 CUDA
    # cores), stream
    "repro_matmul": [_P] * 3 + [_I] * 6 + [_P],
}

# what the last build printed (registers, shared memory, spills per kernel)
BUILD_LOG: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stamp(sources) -> str:
    h = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile the sources into the shared library; returns its path."""
    sources = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    stamp_file = BUILD_DIR / (LIB_NAME + ".stamp")
    stamp = _stamp(sources)
    if (not force and lib.exists() and stamp_file.exists()
            and stamp_file.read_text() == stamp):
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, errors = [], []
    BUILD_LOG.clear()
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{out}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", *objs, "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp_file.write_text(stamp)
    BUILD_LOG.append(f"built {LIB_NAME} from {len(sources)} sources in "
                     f"{time.perf_counter() - t0:.1f} s")
    return lib


_LOAD_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library.  The shards
    of a tensor-parallel program may reach their first kernel at once, from
    one thread each: one of them builds, the others wait for it."""
    with _LOAD_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
