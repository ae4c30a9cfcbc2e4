"""First-use build and ctypes binding of the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so \\
         src/repro_torch/csrc/<name>.cu

The output lands in ``build/repro_torch/`` at the root of the checkout,
named by the content hash of the source and the shared headers
(``csrc/*.cuh``), so an edited source never loads a stale library.
``build()`` starts one ``nvcc`` per missing library, all at once, and
waits for them.  Every C entry point takes its pointers and
the stream as ``void*`` and returns ``cudaGetLastError()`` after its
launch; ``call`` raises if that is not 0.  A launch never waits for the
card.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one
where it launches its kernel, and nowhere else.  Threads launch at once
(the campaign service labels from several), so every change to the
counts is made under one lock.
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
from typing import Dict, Iterable

import torch

__all__ = ["KERNELS", "LAUNCHES", "reset_launches", "count_launch", "build",
           "build_log", "call", "BUILD_DIR", "SRC_DIR"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry point and argument types of each kernel's library
KERNELS: Dict[str, tuple] = {
    # (lut, genes, cols, out, C, S, G, M, per_genome, stream)
    "population_lut": ("population_lut_gather",
                       [_P, _P, _P, _P, _I, _I, _L, _L, _I, _P]),
    # (x, w, packed groups, out, m, n, k, groups, table floats, stream)
    "rank_k": ("rank_k_grouped", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # (x, w, table, out, m, n, k, offset, stream)
    "lut_matmul": ("lut_matmul", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # (x, w, narrowed table, out, m, n, k, offset, table minimum, stream)
    "lut_matmul_sm90": ("lut_matmul_sm90",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # (q, k, v, out, B, H, KVH, sq, sk, d, causal, q_offset, scale, stream)
    "flash_attention": ("flash_attention_fwd",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                         _P]),
    # (q, k, v, out, lse or null, B, H, KVH, sq, sk, d, causal, q_offset,
    #  scale, stream)
    "flash_attention_sm90": ("flash_attention_sm90_fwd",
                             [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _F, _P]),
    # (q, k, v, out, dout, dq, dk, dv, lse, delta, B, H, KVH, sq, sk, d,
    #  causal, scale, stream)
    "flash_attention_bwd": ("flash_attention_bwd",
                            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _F, _P]),
    # (q, k, v, out, dout, lse, dq, dk, dv, delta, dk_part, dv_part, B, H,
    #  KVH, sq, sk, d, causal, scale, stream)
    "flash_attention_bwd_sm90": ("flash_attention_bwd_sm90",
                                 [_P] * 12 + [_I] * 7 + [_F, _P]),
    # (x, dt, A, B, C, h0, y, hT, chunk states or null, b, s, di, n,
    #  stream)
    "selective_scan": ("selective_scan_fwd", [_P] * 9 + [_I] * 4 + [_P]),
    # (x, dt, A, B, C, chunk states, dy, dhT or null, dx, ddt, dA, dB, dC,
    #  dh0, dB partials, dC partials, dA partials, b, s, di, n, stream)
    "selective_scan_bwd": ("selective_scan_bwd", [_P] * 17 + [_I] * 4
                           + [_P]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` (a read-modify-write: under the
    lock, so launches from several threads are all counted)."""
    with _LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    # the source and every shared header it may include
    src = b"".join(p.read_bytes() for p in [SRC_DIR / f"{name}.cu"]
                   + sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns wall seconds per kernel
    compiled here (0.0 for one already built).  Raises with nvcc's
    output when a build fails; ``-Xptxas -v`` output of a successful
    build is kept in ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    walls: Dict[str, float] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            walls[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       time.perf_counter(), tmp, out)
    failures = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        walls[name] = time.perf_counter() - t0
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failures))
    return walls


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is not None:
        return fn
    with _LOCK:
        fn = _FNS.get(name)
        if fn is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            symbol, argtypes = KERNELS[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
    return fn


def call(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream, building it
    on first use, and count the launch.  ``args`` are the C entry
    point's arguments before the stream (see ``KERNELS``).  Raises if
    the launch reported a CUDA error."""
    fn = _fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"repro_torch: {name} kernel launch failed (cudaError {rc}) on "
            f"{device} with arguments {args}")
    count_launch(name)


def build_log(name: str) -> str:
    """nvcc's ``-Xptxas -v`` report of the built library (registers,
    shared memory, spills per kernel)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
