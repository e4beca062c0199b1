"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on first use, into ``_build/`` beside this file
(listed in ``.gitignore``); a library's name carries a digest of its source,
its header and the flags, so an edit rebuilds it.  The libraries are loaded
with ``ctypes``: every pointer and the stream pass as ``c_void_p``, every
C entry returns ``cudaGetLastError()`` and the launcher raises unless it is
0.  Launchers launch on the current stream and allocate nothing but the
chunked reductions' scratch, kept per (device, stream) and reused; the wrappers
in :mod:`nerrf_tpu_torch.ops.segment`, :mod:`.mcts` and :mod:`.attention`
check inputs, allocate the outputs and count the launches.

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
KERNELS = ("sage_aggregate", "gather_rows", "segment_sum",
           "segment_sum_sorted", "gather_rows_sorted", "mcts_search",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source only: the search is bit-equal to its plain version,
# which rounds every product and sum on its own, so nvcc must not contract
# a*b + c into one fused multiply-add there
SOURCE_FLAGS = {"mcts_search": ("-fmad=false",)}
# C entry points that live in another source's library: {entry: library}
ENTRY_LIBRARY = {"mcts_value": "mcts_search", "attention_fwd": "flash_attention",
                 "attention_bwd_dq": "flash_attention",
                 "attention_bwd_dkdv": "flash_attention",
                 "attention_smem": "flash_attention"}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    # msg, dtype, ptr_f, gidx_f, w_f, ptr_r, gidx_r, w_r, B, N, E, F, partial,
    # live, arrivals, out, stream
    "sage_aggregate": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                       _P, _P],
    # table, dtype, idx, B, N, E, F, out, stream
    "gather_rows": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
    # data, dtype, perm (int64), ptr, B, N, S, F, partial, arrivals, out, stream
    "segment_sum": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # data, dtype, ptr, B, N, E, F, partial, arrivals, out, stream
    "segment_sum_sorted": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # table, dtype, idx, B, N, E, F, out, stream
    "gather_rows_sorted": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
    # visits, value_sum, parent, parent_action, children, child_reward,
    # expanded, terminal, state, n_nodes, file_scores, file_loss,
    # proc_scores, prior, real, consts, weights, hidden, B, M, Fp, Pp,
    # num_sims, stream
    "mcts_search": [_P] * 17 + [_I] * 6 + [_P],
    # features, consts, weights, hidden, N, out, stream
    "mcts_value": [_P, _P, _P, _I, _I, _P, _P],
    # q, k, v, dtype, sb, st, sh, B, T, H, D, causal, scale, o, lse, stream
    "attention_fwd": [_P, _P, _P, _I, _L, _L, _L, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    # q, k, v, dtype, sb, st, sh, o, dout, lse, delta, B, T, H, D, causal,
    # scale, dq, stream
    "attention_bwd_dq": [_P, _P, _P, _I, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _F, _P, _P],
    # ... as attention_bwd_dq, then dk, dv, stream
    "attention_bwd_dkdv": [_P, _P, _P, _I, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _F, _P, _P, _P],
    # entry (0 forward, 1 dQ, 2 dK/dV), D (no stream)
    "attention_smem": [_I, _I],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# rows per chunk of the chunked reductions (kChunkRows, csrc/segment_chunks.cuh)
CHUNK_ROWS = 32
# the chunked reductions (csrc/segment_chunks.cuh) hold a row's f32 sums in
# registers: at most 8 elements a lane, 32 lanes
MAX_ROW_WIDTH = 256

_LOCK = threading.Lock()
_FNS: Dict[str, object] = {}


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ())).encode())
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
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
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
                lib = ctypes.CDLL(str(library_path(ENTRY_LIBRARY.get(name, name))))
                fn = getattr(lib, f"nerrf_{name}")
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
                _FNS[name] = fn
    return fn


def _stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, read as
    PyTorch's own generated launchers read it: ``current_stream(device)``
    builds a ``torch.cuda.Stream`` first, 3-8 µs more per launch on the
    H100 machines measured (PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(name: str, device: torch.device, *args, stream=None) -> None:
    # torch.cuda.device(device)'s guard, called directly: its context
    # manager's Python layers cost 1.5-4 µs more per launch (PERF.md)
    prev = torch._C._cuda_exchangeDevice(device.index)
    try:
        err = _fn(name)(*args, _stream(device) if stream is None else stream)
    finally:
        torch._C._cuda_maybeExchangeDevice(prev)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# The chunked reductions' scratch (#1, #3, #4), one buffer of each kind per
# (device, stream), grown as needed: the per-segment arrival counters (int32,
# zero, and every launch leaves the counters it touched at 0 again: the last
# chunk of a segment resets its own), the chunks' f32 partials and
# sage_aggregate's per-chunk live flags (uint8; neither needs an initial
# value).  The launches of one stream run one after another, so they share
# them.
_SCRATCH: Dict[tuple, torch.Tensor] = {}


def _scratch(device: torch.device, stream: int, dtype: torch.dtype, count: int) -> int:
    key = (device, stream, dtype)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < count:
        make = torch.zeros if dtype == torch.int32 else torch.empty
        buf = _SCRATCH[key] = make(max(count, 1 << 16), dtype=dtype, device=device)
    return buf.data_ptr()


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
    """``sage_aggregate`` of ``msg`` [B, N, F] over both sorted edge views
    into ``out``: the chunked reduction over the merged row space of
    ``ptr_f + ptr_r``, N + ceil(2E / 32) chunk slots a window."""
    B, N, F = msg.shape
    _check_row_width("sage_aggregate", F)
    E = gidx_f.shape[1]
    K = N + -(-2 * E // CHUNK_ROWS)
    stream = _stream(msg.device)
    scratch = (_scratch(msg.device, stream, torch.float32, B * K * F),
               _scratch(msg.device, stream, torch.uint8, B * K),
               _scratch(msg.device, stream, torch.int32, B * N))
    _launch("sage_aggregate", msg.device,
            msg.data_ptr(), dtype_code(msg),
            ptr_f.data_ptr(), gidx_f.data_ptr(), w_f.data_ptr(),
            ptr_r.data_ptr(), gidx_r.data_ptr(), w_r.data_ptr(),
            B, N, E, F, *scratch, out.data_ptr(), stream=stream)


def launch_gather(name: str, table, idx, out) -> None:
    """``gather_rows`` or ``gather_rows_sorted`` (``name``, one row-copy
    kernel, csrc/gather_rows.cuh) of ``table`` [B, N, F] by ``idx`` [B, E]
    into ``out`` [B, E, F].  The kernel indexes in 32 bits and runs the
    windows as its grid's y index: larger operands are refused."""
    B, N, F = table.shape
    E = idx.shape[1]
    if max(N, E) * B * F >= 2 ** 31:
        raise ValueError(f"{name}: [{B}, {N}, {F}] by [{B}, {E}] ids is past the "
                         "kernel's 32-bit indexing")
    if B > 65535:
        raise ValueError(f"{name}: {B} windows; the kernel takes at most 65535")
    _launch(name, table.device, table.data_ptr(), dtype_code(table),
            idx.data_ptr(), B, N, E, F, out.data_ptr())


def launch_segment_sum(name: str, data, plan, out) -> None:
    """``segment_sum`` or ``segment_sum_sorted`` (``name``) of ``data``
    [B, S, F] over ``plan`` (a :class:`~nerrf_tpu_torch.ops.segment.SegmentPlan`
    of the ids; the sorted kernel takes no permutation) into ``out``."""
    B, S, F = data.shape
    _check_row_width(name, F)
    N = plan.ptr.shape[1] - 1
    stream = _stream(data.device)
    scratch = (_scratch(data.device, stream, torch.float32, B * plan.num_chunk_slots * F),
               _scratch(data.device, stream, torch.int32, B * N))
    perm = () if name == "segment_sum_sorted" else (
        None if plan.perm is None else plan.perm.data_ptr(),)
    _launch(name, data.device, data.data_ptr(), dtype_code(data), *perm,
            plan.ptr.data_ptr(), B, N, S, F, *scratch, out.data_ptr(),
            stream=stream)



# head widths the attention kernels are instantiated for (csrc/flash_attention.cu)
ATTENTION_HEAD_DIMS = (16, 32, 64, 128)
# the entries and head widths of bf16 attention on the tensor cores (wgmma on
# TMA tiles): all three; every other (type, width) on the CUDA cores
ATTENTION_TMA_ENTRIES = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv")
ATTENTION_TMA_HEAD_DIMS = (64, 128)


def attention_route(name: str, dtype: torch.dtype, D: int) -> str:
    """"wgmma" (tensor cores, TMA tiles) or "fma" (CUDA cores): the route
    ``csrc/flash_attention.cu`` takes for entry ``name``, from the type and
    the head width alone."""
    tma = (name in ATTENTION_TMA_ENTRIES and dtype == torch.bfloat16
           and D in ATTENTION_TMA_HEAD_DIMS)
    return "wgmma" if tma else "fma"


def check_tma_operands(name: str, *tensors) -> None:
    """Raise unless TMA can take every operand: a base aligned to 16 bytes
    and the strides of T, H and B multiples of 16 bytes (D's is 1)."""
    for t in tensors:
        strides = [s * t.element_size() for s in t.stride()[:3]]
        if t.data_ptr() % 16 or any(s % 16 for s in strides):
            raise ValueError(f"{name}: an operand at byte offset {t.data_ptr() % 16} "
                             f"mod 16 with byte strides {strides}; the tensor-core "
                             "route loads by TMA, which takes 16-byte-aligned bases "
                             "and strides that are multiples of 16 bytes")


def attention_smem(name: str, D: int) -> int:
    """Bytes of dynamic shared memory a launch of the tensor-core entry
    ``name`` (attention_fwd, attention_bwd_dq or attention_bwd_dkdv) asks
    for at head width ``D``."""
    return _fn("attention_smem")({"attention_fwd": 0, "attention_bwd_dq": 1,
                                  "attention_bwd_dkdv": 2}[name], D)


def launch_attention(name: str, q, k, v, causal: bool, scale: float, *outs,
                     o=None, dout=None, lse=None, delta=None) -> None:
    """``attention_fwd`` (outs: o, lse), ``attention_bwd_dq`` (outs: dq; the
    tensor-core route also writes ``delta``, rowsum(dout∘o)) or
    ``attention_bwd_dkdv`` (outs: dk, dv; the tensor-core route reads
    ``delta``) over q, k, v [B, T, H, D]
    of one layout (any strides, D's 1); o, dout, the gradients contiguous
    [B, T, H, D], lse and delta [B, H, T] float32."""
    B, T, H, D = q.shape
    if D not in ATTENTION_HEAD_DIMS:
        raise ValueError(f"{name}: head width {D}; the kernel takes {ATTENTION_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"{name}: {B} x {H} heads; the kernel takes at most 65535")
    if attention_route(name, q.dtype, D) == "wgmma":
        # the bf16 tiles: q, k, v and O; q, k, v, dO and dQ, with O, which
        # dQ's prologue reads in 16-byte vectors; or q, k, v, dO, dK and dV
        tiles = {"attention_fwd": (outs[0],),
                 "attention_bwd_dq": (dout, o, *outs)}.get(name, (dout, *outs))
        check_tma_operands(name, q, k, v, *tiles)
    sb, st, sh, _ = q.stride()
    rows = () if name == "attention_fwd" else (
        o.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), dtype_code(q),
            sb, st, sh, *rows, B, T, H, D, int(causal), scale,
            *(t.data_ptr() for t in outs))
