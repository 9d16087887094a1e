"""Build and load the port's CUDA kernels (no JAX counterpart).

Each source ``csrc/<source>.cu`` exports one or more C entry points. At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the repository root (git-ignored), named
by a hash of the sources and flags, and loaded with ``ctypes``. A later
process with the same sources reuses the library; a changed source builds
anew.

Binding rules: every pointer and the stream travel as ``c_void_p`` (a
plain ``c_int`` would cut a 64-bit address), the stream is PyTorch's
current one, and each C entry returns ``cudaGetLastError()`` so a launch the
card refuses raises in the wrapper instead of vanishing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry point -> (source under csrc/, argtypes); the return type is always int
SIGNATURES = {
    # q, k, v, qpos, kpos, out, lse, bh, sq, sk, d, group, h, sm_scale,
    # dtype (0 fp32 / 1 bf16), stream
    "flash_fwd": ("flash_fwd", [P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P]),
    # q, k_pages, v_pages, k_scale, v_scale, block_table, cache_len, out,
    # workspace, b, n_kv, group, hd, page_size, pages_per_seq, sm_scale,
    # q dtype (0 fp32 / 1 bf16), pool dtype (0 fp32 / 1 bf16 / 2 int8), stream
    "paged_decode": ("paged_decode", [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                      F, I, I, P]),
    # q, k, v, do, lse, delta, qpos, kpos, dk, dv, bkv, sq, sk, d, group, h,
    # sm_scale, dtype (0 fp32 / 1 bf16), stream
    "flash_bwd_dkdv": ("flash_bwd", [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                     F, I, P]),
    # q, k, v, do, lse, delta, qpos, kpos, dq, bh, sq, sk, d, group, h,
    # sm_scale, dtype, stream
    "flash_bwd_dq": ("flash_bwd", [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P]),
    # g, mu, nu, master, p, scalars, n, b1, 1 - b1, b2, 1 - b2, eps, wd,
    # g dtype (0 fp32 / 1 bf16), p dtype (0 fp32 / 1 bf16), stream
    "fused_adamw": ("adamw", [P, P, P, P, P, P, L, F, F, F, F, F, F, I, I, P]),
}
SOURCES = tuple(sorted({source for source, _ in SIGNATURES.values()}))

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}   # C entry point -> its ctypes function
# compiler output (``-Xptxas -v``: registers, shared memory, spills) and
# wall seconds of each build done by this process, by source
build_log: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit")


def _sources(name: str) -> List[Path]:
    return [CSRC / f"{name}.cu"]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out),
            *map(str, _sources(name))]


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together. Raises with the compiler's output when one
    fails. Returns source -> library path."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - t0
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, paths[n])   # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(entry: str):
    """The C entry point, its source built and loaded on first use in this
    process."""
    fn = _entries.get(entry)
    if fn is None:
        source, argtypes = SIGNATURES[entry]
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build([source])[source]))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[entry] = fn
    return fn


def call(entry: str, *args) -> None:
    """Launch a kernel's C entry; raise when the launch was refused."""
    err = load(entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with cudaError {err}")


def ptr(t) -> int:
    return t.data_ptr() if t is not None else None


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream

