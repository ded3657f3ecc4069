"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  Libraries
land in ``spark_rapids_tpu_torch/_build/`` (git-ignored), named by a hash
of the sources and flags, so an edited kernel is rebuilt and a built one
is reused.  :func:`build` compiles every missing library at once, one
``nvcc`` process per source, all started together.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.  A kernel wrapper that is handed a CUDA tensor
calls :func:`lib`, which builds on first use and raises if it cannot.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build", "lib", "share_limits", "stream_ptr", "check",
           "param_table", "lookback_status", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: library name -> CUDA source under csrc/
SOURCES = {
    "compact": "compact.cu",
    "gather": "gather.cu",
    "sort": "sort.cu",
    "segmented": "segmented.cu",
    "join_probe": "join_probe.cu",
    "join_ids": "join_ids.cu",
    "join_expand": "join_expand.cu",
    "hash_partition": "hash_partition.cu",
    "partition_group": "partition_group.cu",
    "window_segments": "window_segments.cu",
    "window_agg": "window_agg.cu",
    "string_substr": "string_substr.cu",
    "string_match": "string_match.cu",
    "string_concat": "string_concat.cu",
    "string_case": "string_case.cu",
    "string_hex": "string_hex.cu",
    "wirecodec": "wirecodec.cu",
    "range_partition": "range_partition.cu",
    "window_range": "window_range.cu",
    "generate": "generate.cu",
    "string_funcs": "string_funcs.cu",
    "mesh_exchange": "mesh_exchange.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

#: C entry points and their argument types (every one returns a
#: cudaError_t as int and takes the stream last, but the ``_limits``
#: entries, which report a library's constants)
_SIGNATURES = {
    "compact": {
        "srt_compact_count": [_P, _L, _P, _P, _P, _P],
        "srt_compact_copy": [_P, _L, _I, _P, _P, _L, _P, _P],
        "srt_compact_limits": [_P, _I],
    },
    "gather": {
        "srt_gather": [_P, _L, _I, _P, _P, _L, _P],
        "srt_gather_limits": [_P, _I],
    },
    "sort": {
        "srt_sort_plan": [_P, _P, _I, _I, _L, _P, _I, _P],
        "srt_sort_encode": [_P, _P, _I, _P, _P, _I, _I, _L, _P, _P, _L, _P],
        "srt_sort_word": [_P, _I, _I, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, ctypes.POINTER(ctypes.c_int), _P],
        "srt_sort_limits": [_P, _I],
    },
    "segmented": {
        "srt_seg_bounds": [_P, _L, _I, _P, _I, _P, _P, _P, _P, _L, _P],
        "srt_seg_agg_tiles": [_P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _L,
                              _I, _P],
        "srt_seg_agg_combine": [_P, _L, _I, _I, _I, _P, _P, _P, _I, _P, _P,
                                _L, _I, _I, _P],
        "srt_segmented_limits": [_P, _I],
        "srt_seg_percentile": [_P, _L, _P, _P, _I, _P, _I, _P, _P, _P],
        "srt_seg_string_minmax": [_I, _P, _P, _P, _I, _P, _L, _P, _P, _I,
                                  _P, _P, _P],
    },
    "join_probe": {
        "srt_join_build_keys": [_P, _P, _P, _L, _I, _P, _P, _P, _I, _P],
        "srt_join_search": [_P, _P, _L, _P, _L, _P, _P, _I, _I, _I, _P, _P,
                            _P, _P, _P, _I, _P, _P],
        "srt_join_probe_limits": [_P, _I],
    },
    "join_ids": {
        "srt_join_key_ids": [_P, _P, _I, _I, _P, _I, _I, _L, _L, _P, _P,
                             _P],
        "srt_join_ids_limits": [_P, _I],
    },
    "join_expand": {
        "srt_join_offsets": [_P, _L, _P, _P, _P],
        "srt_join_expand": [_P, _L, _P, _P, _P, _L, _I, _P, _P, _L, _P, _P,
                            _P],
        "srt_join_mark": [_P, _L, _P, _P],
        "srt_join_expand_limits": [_P, _I],
    },
    "hash_partition": {
        "srt_hash_partition": [_P, _P, _P, _P, _P, _I, _L, _P,
                               ctypes.c_uint, _I, _P, _P],
    },
    "partition_group": {
        "srt_partition_upsweep": [_P, _L, _I, _P, _P, _P, _P],
        "srt_partition_scatter": [_P, _L, _I, _I, _P, _P, _P, _P],
        "srt_partition_group_limits": [_P, _I],
    },
    "window_segments": {
        "srt_window_segments": [_P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P],
    },
    "window_agg": {
        "srt_window_agg": [_I, _P, _P, _I, _I, _P, _P, _P, _L, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _I, _P],
        "srt_window_agg_piece_bytes": [],
    },
    "string_substr": {
        "srt_substring": [_P, _P, _P, _L, _I, _P, _P, _L, _P, _P, _L, _P,
                          _P, _P, _P],
    },
    "string_match": {
        "srt_string_match": [_I, _P, _P, _P, _L, _I, _P, _P, _P, _I, _I,
                             _P, _P, _P],
    },
    "string_concat": {
        "srt_concat": [_I, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _P,
                       _P, _P, _P],
    },
    "string_case": {
        "srt_case_map": [_P, _P, _L, _I, _P],
    },
    "string_hex": {
        "srt_hex": [_P, _P, _P, _P, _L, _P],
    },
    "wirecodec": {
        "srt_decode_batch": [_P, _L, _I, _P, _L, _P],
        "srt_wirecodec_limits": [_P, _I],
        "srt_decode_dict": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _L, _P],
    },
    "range_partition": {
        "srt_range_bound_fields": [_P, _P, _I, _I, _L, _P, _P],
        "srt_range_partition": [_P, _P, _I, _I, _P, _I, _L, _P, _P],
        "srt_range_partition_limits": [_P, _I],
    },
    "window_range": {
        "srt_window_range_width": [_P, _P, _L, _P, _P],
        "srt_window_range": [_I, _I, _I, _P, _P, _P, _P, _L, _I, _P, _P, _P,
                             _P, _P],
    },
    "generate": {
        "srt_split_counts": [_P, _I, _P, _P, _L, _I, _I, _P, _P, _P],
        "srt_split_emit": [_P, _I, _P, _P, _L, _I, _I, _P, _P, _I, _P, _P,
                           _P, _P, _P],
        "srt_array_emit": [_P, _I, _I, _P, _P, _L, _I, _P, _P, _P, _P, _P,
                           _P],
    },
    "string_funcs": {
        "srt_trim": [_P, _P, _P, _L, _I, _I, _P, _P, _P],
        "srt_substring_index": [_P, _P, _P, _L, _I, _I, _I, _P, _P, _P],
        "srt_char_length": [_P, _P, _P, _L, _I, _P, _P],
        "srt_locate": [_P, _P, _P, _L, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                       _P],
    },
    "mesh_exchange": {
        "srt_mesh_pack": [_P, _L, _I, _I, _L, _P, _P, _P, _P],
        "srt_mesh_unpack": [_P, _L, _I, _L, _P, _P],
        "srt_mesh_exchange_limits": [_P, _I],
    },
}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
#: library name -> the constants its wrapper shares with it
_LIMITS: dict[str, tuple] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "spark_rapids_tpu_torch need the CUDA toolkit "
                       "(set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named libraries (default: all) that are not built yet,
    in parallel.  Returns {name: ptxas report or ""}; raises with the
    compiler's output if any build fails."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
        if verbose:
            cmd.append("-Xptxas=-v")
        cmd += ["-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {n: "" for n in names}, []
    for name, (p, tmp, out) in procs.items():
        text, _ = p.communicate()
        reports[name] = text
        if p.returncode != 0:
            failed.append(f"--- nvcc {SOURCES[name]} (rc {p.returncode})\n"
                          f"{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def share_limits(name: str, limits: tuple) -> None:
    """Record the constants a Python wrapper shares with the library
    ``name``: when it is loaded, its ``srt_<name>_limits`` must report
    them in the same order, else :func:`lib` raises."""
    _LIMITS[name] = tuple(limits)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    with _LOCK:
        dll = _LOADED.get(name)
        if dll is not None:
            return dll
        path = _lib_path(name)
        if not path.exists():
            build([name])
        dll = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(dll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        want = _LIMITS.get(name)
        if want:
            got = (ctypes.c_int64 * len(want))()
            getattr(dll, f"srt_{name}_limits")(got, len(want))
            if tuple(got) != want:
                raise RuntimeError(f"csrc/{SOURCES[name]} reports the "
                                   f"limits {tuple(got)}, its wrapper "
                                   f"expects {want}")
        _LOADED[name] = dll
        return dll


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw pointer
    (read without building a ``torch.cuda.Stream`` where PyTorch offers
    that: a wrapper's whole host cost is a few microseconds)."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        index = device if isinstance(device, int) \
            else getattr(device, "index", None)
        return raw(torch.cuda.current_device() if index is None else index)
    return torch.cuda.current_stream(device).cuda_stream


def param_table(words, copy: bool, device):
    """A kernel's table of int64 ``words``: a host array, which the C entry
    point copies into the kernel's parameters, and, where ``copy`` (the
    table is longer than the parameters hold), a device copy the kernel
    reads instead (else None)."""
    import array
    import torch
    host = array.array("q", words)
    return host, (torch.tensor(words, dtype=torch.int64).to(device)
                  if copy else None)


def lookback_status(store: dict, device, stream: int, ntiles: int):
    """The uint64 status of a kernel's decoupled look-back
    (``csrc/common.cuh`` ``lookback_*``) on ``device`` and ``stream``,
    kept in ``store``: at least ``ntiles + 2`` words, zero between
    launches (the last tile of each launch clears what it used), so a
    caller never clears it; grown as needed."""
    import torch
    key = (device.index, stream)
    st = store.get(key)
    if st is None or st.numel() < ntiles + 2:
        st = torch.zeros(max(ntiles + 2, 1024), dtype=torch.int64,
                         device=device)
        store[key] = st
    return st


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {rc}")

