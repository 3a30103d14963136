"""Hand-written CUDA kernels and their plain PyTorch versions.

The counterpart of ``fenicssolver_tpu/ops/pallas_kernels.py``.  Each kernel
has a wrapper that takes tensors: on a CPU tensor it runs the kernel's
plain PyTorch version (the path the CPU tests take); on a CUDA tensor it
launches the kernel, or raises — there is no fallback from one to the
other.  Each wrapper adds one to ``LAUNCHES[name]`` where it launches.

Build: the CUDA sources under ``csrc/`` are compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``.  The library goes into ``_build/`` (listed in
``.gitignore``) under a name keyed on the source's hash; it is written to a
temporary name and renamed, so parallel workers cannot race.

Kernels:

- ``stencil_apply_const`` (``csrc/stencil.cu``): the constant-coefficient
  15-tap stencil, the GMG level operator.  Replaces
  ``fenicssolver_tpu/ops/pallas_kernels.py:363``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from .structured import OFFSETS

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.normpath(os.path.join(_HERE, "..", "csrc"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))

#: launches per kernel since the last ``reset_launch_counts()``
LAUNCHES = {"stencil_apply_const": 0}

#: what the last build of each library did: {name: {"seconds", "log", "path"}}
BUILD_INFO = {}

_libs = {}

_CENTER_IDX = [tuple(int(v) for v in o) for o in OFFSETS].index((0, 0, 0))


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels of fenicssolver_tpu_torch are built from csrc/ at first use"
    )


def build(name):
    """Compile ``csrc/<name>.cu`` for sm_90a (if not built yet) and return
    the path of the shared library."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(so):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "(cached)", "path": so})
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, src,
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)
    BUILD_INFO[name] = {
        "seconds": time.perf_counter() - t0,
        "log": (proc.stdout + proc.stderr).strip(),
        "path": so,
    }
    return so


def _stencil_lib():
    lib = _libs.get("stencil")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build("stencil"))
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    for fn in ("fst_stencil_apply_const_f64", "fst_stencil_apply_const_f32"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [vp, vp, vp, i64, i64, i64, ctypes.POINTER(ctypes.c_double), vp]
    lib.fst_stencil_offsets.restype = None
    lib.fst_stencil_offsets.argtypes = [ctypes.POINTER(ctypes.c_int)]
    table = (ctypes.c_int * 45)()
    lib.fst_stencil_offsets(table)
    if not np.array_equal(np.array(table[:]).reshape(15, 3), OFFSETS):
        raise RuntimeError("csrc/stencil.cu offset table differs from OFFSETS")
    _libs["stencil"] = lib
    return lib


def _taps(coefs):
    taps = np.ascontiguousarray(
        np.asarray(
            coefs.detach().cpu().numpy() if torch.is_tensor(coefs) else coefs,
            dtype=np.float64,
        ).reshape(-1)
    )
    if taps.shape != (15,):
        raise ValueError(f"expected 15 stencil taps, got shape {taps.shape}")
    return taps


# ---------------------------------------------------------------------------
# K2: constant-coefficient 15-tap stencil (GMG level operator)
# ---------------------------------------------------------------------------


def stencil_apply_const_reference(x3, coefs, free3=None):
    """Plain PyTorch version: ``A(x3)``, or ``free3 * A(free3 * x3)`` with a
    mask, where ``A`` is the zero-padded 15-tap apply of ``la/gmg``.

    The sum runs centre tap first, then the other taps in offset order, as
    ``fenicssolver_tpu/la/gmg.stencil_apply`` does."""
    c = _taps(coefs)
    xm = x3 if free3 is None else free3 * x3
    nx, ny, nz = xm.shape
    xp = F.pad(xm, (1, 1, 1, 1, 1, 1))
    y = float(c[_CENTER_IDX]) * xm
    for oi, (di, dj, dk) in enumerate(OFFSETS):
        if oi == _CENTER_IDX:
            continue
        y = y + float(c[oi]) * xp[
            1 + di : 1 + di + nx, 1 + dj : 1 + dj + ny, 1 + dk : 1 + dk + nz
        ]
    return y if free3 is None else free3 * y


def stencil_apply_const(x3, coefs, free3=None):
    """Constant-coefficient 15-tap stencil, ``free3 * A(free3 * x3)`` (or
    ``A(x3)`` without a mask).

    ``x3``, ``free3``: (Nx, Ny, Nz) tensors of one dtype on one device;
    ``coefs``: 15 taps aligned with ``ops/structured.OFFSETS``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel of
    ``csrc/stencil.cu`` on the current stream."""
    if x3.device.type == "cpu":
        return stencil_apply_const_reference(x3, coefs, free3)
    if x3.device.type != "cuda":
        raise ValueError(f"stencil_apply_const: unsupported device {x3.device}")
    if x3.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stencil_apply_const: unsupported dtype {x3.dtype}")
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(
            "stencil_apply_const: x3 must be a contiguous (Nx, Ny, Nz) tensor, "
            f"got shape {tuple(x3.shape)}"
        )
    if x3.numel() >= 2**31:
        raise ValueError("stencil_apply_const: lattice too large for the kernel")
    if free3 is not None and (
        free3.shape != x3.shape
        or free3.dtype != x3.dtype
        or free3.device != x3.device
        or not free3.is_contiguous()
    ):
        raise ValueError(
            "stencil_apply_const: free3 must be a contiguous tensor of the "
            "shape, dtype and device of x3"
        )
    taps = _taps(coefs)
    lib = _stencil_lib()
    fn = (
        lib.fst_stencil_apply_const_f64
        if x3.dtype == torch.float64
        else lib.fst_stencil_apply_const_f32
    )
    y = torch.empty_like(x3)
    nx, ny, nz = x3.shape
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = fn(
            x3.data_ptr(),
            None if free3 is None else free3.data_ptr(),
            y.data_ptr(),
            nx, ny, nz,
            taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"stencil_apply_const: kernel launch failed with CUDA error {rc}"
        )
    LAUNCHES["stencil_apply_const"] += 1
    return y
