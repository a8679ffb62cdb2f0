"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface (no PyTorch headers): one ``nvcc -c`` per source, all started
together, then one link (about half a minute, most of it the warp walks'
instantiations in ``sgbm_wta.cu``). The library goes in
``csrc/build/`` under a name keyed by a hash of the sources and flags. The
first call of :func:`library` in a process builds it if that file is
missing and loads it; later calls return the loaded library.

No ``--use_fast_math``: the SGBM kernels rely on IEEE division and
``rintf`` to reproduce the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from openvo_tpu_torch import trace

# Imported by every kernel wrapper module: the port's exactness contracts
# (exact float32 products in the matcher, the remap and the pose fit) hold
# only without TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P, _I, _LL, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_double)
# C entry points of csrc/*.cu: name -> argument types. Each returns the
# cudaError_t of its launch.
SIGNATURES = {
    # lp, rp, C, s1, H, W, D, min_disp, radius, sentinel, P1, P2, bf16,
    # row0, rows, clamp_lo, clamp_hi, frames, stream
    "ovo_cost_hsweep": (_P, _P, _P, _P) + (_I,) * 14 + (_P,),
    # C, C is float32, sv, H, W, D, P1, P2, dir0, ndirs, down, up, assign
    # (float32: sv = L), init carry (or NULL), carry out (or NULL), frames,
    # a frame's carry elements, stream
    "ovo_vsweep": (_P, _I, _P) + (_I,) * 10 + (_P, _P, _I, _LL, _P),
    # C (int16), s1, H, W, D, P1, P2, up, frames, scratch, its bytes,
    # stream
    "ovo_vsweep_trio": (_P, _P) + (_I,) * 7 + (_P, _LL, _P),
    # (no arguments) the scratch's bytes on the current device
    "ovo_vsweep_trio_scratch": (),
    # C, out, H, W, D, P1, P2, stream
    "ovo_hsweep": (_P, _P, _I, _I, _I, _I, _I, _P),
    # C, C is float32, s1, sv, svu (or NULL), disp16, H, W, D, P1, P2,
    # min_disp, uniqueness, disp12, stream
    "ovo_hsweep_wta_lr": (_P, _I, _P, _P, _P, _P) + (_I,) * 8 + (_P,),
    # stack, nl, H, W, octave, xy, cos, sin, valid, pattern, taps (host),
    # out, K (a frame), frames, stream
    "ovo_brief_describe": (_P, _I, _I, _I) + (_P,) * 8 + (_I, _I, _P),
    # img, H, W, nl, tiles, ntiles, spans, nspans, r0, rn, rw, c0, cn, cw,
    # taps, stack, frames, stream
    "ovo_resize_levels": (_P, _I, _I, _I, _P, _I, _P, _I) + (_P,) * 6 + (
        _I, _P, _I, _P),
    # stack, H, W, nl, tiles, ntiles, spans, nspans, mask (or NULL), rows,
    # cols (or NULL), threshold, key, fkey (or NULL), frames, stream
    "ovo_corner_keys": (_P, _I, _I, _I, _P, _I, _P, _I) + (_P,) * 3 + (
        _F, _P, _P, _I, _P),
    # disp, disp is int32, valid, labels, size (scratch), keep, frames, H,
    # W, max_diff, window, stream
    "ovo_speckle_keep": (_P, _I) + (_P,) * 4 + (_I,) * 5 + (_P,),
    # cons, num, out, clouds, N, stream
    "ovo_greedy_clique": (_P, _P, _P, _I, _I, _P),
    # src, dst, mask, T, B, N, stream
    "ovo_kabsch_fit": (_P, _P, _P, _P, _I, _I, _P),
    # a (float32 where m < n, else float64), S, V, U (or NULL), sweeps, B,
    # m, n, tol, max sweeps, stream
    "ovo_jacobi_svd": (_P,) * 5 + (_I, _I, _I, _D, _I, _P),
    # events (anchor, then a replay's marks), their count, ms out
    "ovo_event_times": (_P, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libovo_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    The compiler's register/shared-memory report goes to ``<lib>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(c, log) for c, p, log in zip(cmds, procs, logs) if p.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((link, logs[-1]))
    out.with_suffix(".log").write_text("".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        cmd, log = failed[0]
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{log[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Traced, recorded
    always: the span ``ovo.library`` and the counter
    ``ovo.library_builds``, 1 where this process ran nvcc, 0 where it
    loaded the library built before."""
    with trace.span("ovo.library", always=True):
        built = not library_path().exists()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        trace.count("ovo.library_builds", int(built), always=True)
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
