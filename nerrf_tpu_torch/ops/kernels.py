"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on first use, into ``_build/`` beside this file
(listed in ``.gitignore``); a library's name carries a digest of its source,
its header and the flags, so an edit rebuilds it.  The libraries are loaded
with ``ctypes``: every pointer and the stream pass as ``c_void_p``, every
C entry returns ``cudaGetLastError()`` and the launcher raises unless it is
0.  Launchers allocate nothing and launch on the current stream; the
wrappers in :mod:`nerrf_tpu_torch.ops.segment` check inputs, allocate the
outputs and count the launches.

Nothing here runs at import: the CPU build of PyTorch imports this module
too, and has neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("sage_aggregate", "gather_rows", "segment_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # msg, dtype, ptr_f, gidx_f, w_f, ptr_r, gidx_r, w_r, B, N, E, F, out, stream
    "sage_aggregate": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # table, dtype, idx, B, N, E, F, out, stream
    "gather_rows": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
    # data, dtype, ptr, perm, B, N, S, F, out, stream
    "segment_sum": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the warp-per-row kernels hold a row in registers: 32 lanes x kMaxChunks
# (csrc/common.cuh) features at most
MAX_ROW_WIDTH = 256

_LOCK = threading.Lock()
_FNS: Dict[str, object] = {}


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def build() -> Dict[str, float]:
    """Compile every kernel whose library is missing: one ``nvcc`` per
    source, all started together.  Returns the seconds each build took (0.0
    for a library already built); raises with the compiler's output when one
    fails.  ``_build/<lib>.log`` keeps what ``-Xptxas -v`` reported."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in KERNELS:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT),
                         tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in KERNELS}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        with _LOCK:
            fn = _FNS.get(name)
            if fn is None:
                build()
                lib = ctypes.CDLL(str(library_path(name)))
                fn = getattr(lib, f"nerrf_{name}")
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
                _FNS[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def dtype_code(t: torch.Tensor) -> int:
    code = _DTYPE_CODE.get(t.dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {t.dtype}")
    return code


def _check_row_width(name: str, F: int) -> None:
    if F > MAX_ROW_WIDTH:
        raise ValueError(f"{name}: rows of {F} features; the kernel takes at "
                         f"most {MAX_ROW_WIDTH}")


def launch_sage_aggregate(msg, ptr_f, gidx_f, w_f, ptr_r, gidx_r, w_r, out) -> None:
    B, N, F = msg.shape
    _check_row_width("sage_aggregate", F)
    E = gidx_f.shape[1]
    _launch("sage_aggregate", msg.device,
            msg.data_ptr(), dtype_code(msg),
            ptr_f.data_ptr(), gidx_f.data_ptr(), w_f.data_ptr(),
            ptr_r.data_ptr(), gidx_r.data_ptr(), w_r.data_ptr(),
            B, N, E, F, out.data_ptr())


def launch_gather_rows(table, idx, out) -> None:
    B, N, F = table.shape
    E = idx.shape[1]
    _launch("gather_rows", table.device, table.data_ptr(), dtype_code(table),
            idx.data_ptr(), B, N, E, F, out.data_ptr())


def launch_segment_sum(data, ptr, perm, num_segments, out) -> None:
    B, S, F = data.shape
    _check_row_width("segment_sum", F)
    _launch("segment_sum", data.device, data.data_ptr(), dtype_code(data),
            ptr.data_ptr(), perm.data_ptr(), B, num_segments, S, F,
            out.data_ptr())
