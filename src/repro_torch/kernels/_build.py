"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library, bind with ctypes.

Every source is compiled for ``sm_90a`` into an object file (one ``nvcc``
per source, all started together), and one more ``nvcc`` links them into
``build/repro_torch_kernels/<hash of sources and flags>/libkernels.so``
under the checkout.  A changed source gives a new hash and so a new build;
an unchanged one loads the library already built.  The C entry points take
``void*`` pointers, ``int`` sizes and the stream and return a
``cudaError_t``; the Python wrappers raise when it is not 0.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: C entry point -> argtypes (every entry point returns a cudaError_t but
#: the flash_attention*_route functions, which return the route they name)
SIGNATURES = {
    # x, scale, y, rows, d, x's row stride, eps, dtype code, vector route,
    # stream
    "rmsnorm_launch": [_P, _P, _P, _I, _I, _L, _F, _I, _I, _P],
    # x, scale, g, dx, dscale, partial, rows, d, eps, max blocks,
    # dtype code, vector route, stream
    "rmsnorm_bwd_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I,
                           _P],
    # q, k, v, o, lse (or null), B, Hq, Hkv, Sq, Sk, D, Dv, scale, causal,
    # window, q_offset, dtype code, stream
    "flash_attention_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _I, _I, _P],
    # q, k, v, o, Sk, D, Dv, dtype code -> 1 for the tensor-core route
    "flash_attention_route": [_P, _P, _P, _P, _I, _I, _I, _I],
    # q, k, v, o, do, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D, Dv,
    # scale, causal, window, q_offset, dtype code, stream
    "flash_attention_bwd_launch": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _I,
                                                           _I, _P],
    # q, k, v, do, dq, dk, dv, D, Dv, dtype code -> 1 for the tensor-core
    # passes
    "flash_attention_bwd_route": [_P] * 7 + [_I] * 3,
    # p, g, m, m scales, v, v scales, scalars, rows, L, b1, 1 - b1, b2,
    # 1 - b2, eps, weight decay, apply_wd, p dtype, g dtype, quant, vector
    # route, stream
    "fused_adamw_launch": [_P] * 7 + [_I, _I] + [_F] * 6 + [_I] * 5 + [_P],
    # q, k_pages, v_pages, page_table, seq_lens, o, workspace (or null),
    # B, Hq, Hkv, D, Dv, page, maxp, partition pages, scale, dtype code,
    # split route, stream
    "paged_attention_launch": [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P],
    # q, k, v, cache_len and offset (each null when passed by value), o,
    # lse (or null), workspace, q's (batch, head) strides, k's and v's
    # (batch, head, position) strides, cache_len's and offset's values,
    # their int64 flags, B, Hq, Hkv, Smax, D, Dv, window, n_split, scale,
    # dtype code, vector route, partials, stream
    "decode_attention_launch": [_P] * 8 + [_L] * 10 + [_I] * 10
    + [_F, _I, _I, _I, _P],
    # x, dt, A, B, C, D, h0 (or null), y, h_final, Bt, S, H, P, N, Q,
    # (batch, sequence) strides of x, B and C, dtype code, stream
    "ssd_scan_launch": [_P] * 9 + [_I] * 6 + [_L] * 6 + [_I, _P],
    # x, dt, A, B, C, D, h0 (or null), y, h_final, acum, cb, states, Bt,
    # S, H, P, N, Q, (batch, sequence) strides of x, B and C, stream
    "ssd_scan_chunked_launch": [_P] * 12 + [_I] * 6 + [_L] * 6 + [_P],
    # x, dt, A, B, C, D, h0 (or null), dy, dh_final (or null), dx, ddt, dA,
    # dB, dC, dD, dh0, workspace, Bt, S, H, P, N, Q, (batch, sequence)
    # strides of x, B and C, dtype code, stream
    "ssd_scan_bwd_launch": [_P] * 17 + [_I] * 6 + [_L] * 6 + [_I, _P],
    # the same arguments but the dtype code (bf16 only): the tensor-core
    # route
    "ssd_scan_bwd_tc_launch": [_P] * 17 + [_I] * 6 + [_L] * 6 + [_P],
    # gates_x, its (batch, position, gate, head) strides, r, r's dtype
    # code, h0, c0, n0, m0 (all null for the zero state), hs, the final h,
    # c, n, m, the saved gates and states (both null without), B, S, H, Dh,
    # dtype code, stack dtype code, stream
    "slstm_fwd_launch": [_P] + [_L] * 4 + [_P, _I] + [_P] * 11 + [_I] * 6
    + [_P],
    # r, r's dtype code, the saved gates and states, dhs, the final state's
    # cotangents (each null for zero), dgx, dG, the initial state's
    # cotangents, B, S, H, Dh, dtype code, stack dtype code, stream
    "slstm_bwd_launch": [_P, _I] + [_P] * 13 + [_I] * 6 + [_P],
    # q, k, v, i_gate, f_gate, their (batch, head, position) strides, C0,
    # n0, m0 (all null for the zero carry), h and its strides, the carries
    # entering each chunk (C, n, m), G, mloc, the final C, n, m, D' and the
    # fp32 h (both null without), B, H, S, Dk, Dv, chunk, dtype code,
    # stream
    "mlstm_fwd_launch": [_P] * 5 + [_L] * 15 + [_P] * 4 + [_L] * 3
    + [_P] * 10 + [_I] * 7 + [_P],
    # q .. f_gate and their strides, dh and its strides, the final carry's
    # cotangents (each null for zero), C0 and n0 (null without a carry),
    # the forward's nine saved tensors, dq, dk, dv, di, df, the carry's
    # cotangents (null without), the workspace, B, H, S, Dk, Dv, chunk,
    # dtype code, stream
    "mlstm_bwd_launch": [_P] * 5 + [_L] * 15 + [_P] + [_L] * 3
    + [_P] * 23 + [_I] * 7 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def default_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd, log):
    log.write(("$ " + " ".join(cmd) + "\n").encode())
    log.flush()
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def build(nvcc: Optional[str] = None) -> Path:
    """Compile and link the library if this source hash has none yet;
    return its path.  Raises ``RuntimeError`` when ``nvcc`` is missing or
    fails (the log beside the library says why)."""
    nvcc = nvcc or default_nvcc()
    if not (os.path.isfile(nvcc) and os.access(nvcc, os.X_OK)):
        raise RuntimeError(f"nvcc not found at {nvcc!r}: the CUDA kernels "
                           f"cannot be built (set CUDA_HOME)")
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir / "build.log"
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp, \
            open(log_path, "wb") as log, contextlib.ExitStack() as stack:
        objs, procs, logs = [], [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            # one log each, joined in source order: ptxas's report of
            # each kernel stays next to its own name
            logs.append(stack.enter_context(
                open(os.path.join(tmp, src.stem + ".log"), "w+b")))
            procs.append(_run([nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src),
                               "-o", obj], logs[-1]))
        rcs = [p.wait() for p in procs]
        for part_log in logs:
            part_log.seek(0)
            log.write(part_log.read())
        log.flush()
        if any(rcs):
            raise RuntimeError(f"nvcc failed (rc {rcs}); see {log_path}:\n"
                               + log_path.read_text()[-4000:])
        part = os.path.join(tmp, "libkernels.so")
        if _run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", part],
                log).wait():
            raise RuntimeError(f"nvcc link failed; see {log_path}:\n"
                               + log_path.read_text()[-4000:])
        os.replace(part, lib)      # atomic: a half-written .so never loads
    return lib


def load(nvcc: Optional[str] = None) -> ctypes.CDLL:
    """The kernels' shared library, built at first use and then cached
    for the process, with every entry point's ``argtypes`` set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build(nvcc)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            # Bt, S, H, P, N, Q -> fp32 elements of the SSD backward's
            # workspace, scalar or tensor-core route (-1: dimensions the
            # route does not take)
            for name in ("ssd_scan_bwd_workspace",
                         "ssd_scan_bwd_tc_workspace"):
                getattr(lib, name).argtypes = [_I] * 6
                getattr(lib, name).restype = _L
            # B, H, Dk, Dv, chunk, chunks -> fp32 elements of the mLSTM
            # backward's workspace
            lib.mlstm_bwd_workspace.argtypes = [_I] * 6
            lib.mlstm_bwd_workspace.restype = _L
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a C entry point."""
    if err != 0:
        name = _LIB.cuda_error_string(err) if _LIB is not None else b"?"
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({name.decode(errors='replace')})")
