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

Kernels (ids of the table in ``PERF.md``):

- K2 ``stencil_apply_const`` (``csrc/stencil.cu``): the constant-coefficient
  15-tap stencil, the GMG level operator.  Replaces
  ``fenicssolver_tpu/ops/pallas_kernels.py:363``.
- K1 ``stencil_apply_var`` (``csrc/stencil.cu``): the variable-coefficient
  15-tap stencil, the PCG operator of the structured-lattice Poisson path.
  Replaces ``fenicssolver_tpu/ops/pallas_kernels.py:308``.
- K3 ``p1_stiffness_sym`` (``csrc/p1_stiffness.cu``): packed symmetric 3-D
  P1 element stiffness, slots ``SYM10``.  Replaces
  ``fenicssolver_tpu/ops/pallas_kernels.py:144``.
- K4 ``p1_stiffness`` (``csrc/p1_stiffness.cu``): generic P1 element
  stiffness.  Replaces ``fenicssolver_tpu/ops/pallas_kernels.py:74``.
- K5 ``element_matvec`` (``csrc/element_matvec.cu``): the batched element
  matvec ``y_e = A_e x_e`` of the matrix-free operator
  (``parallel/sharding.py``).  Replaces
  ``fenicssolver_tpu/ops/pallas_kernels.py:28``.
- ``csr_spmv`` (``csrc/csr_spmv.cu``): a CSR matrix times a vector or a
  block of columns, each row summed in an order fixed by the matrix (a
  group of ``spmv_lanes`` threads a row and column, a fixed shuffle tree):
  the products of the AMG
  V-cycles (``la/amg.py``, ``parallel/amg_halo.py``).  Not a TPU kernel:
  it repairs F5 (ROADMAP.md), PyTorch's CSR product summing long rows in
  an order that changes from run to run.

Every kernel takes tensors of fewer than 2^31 elements (raises otherwise).
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
LAUNCHES = {
    "stencil_apply_const": 0,
    "stencil_apply_var": 0,
    "p1_stiffness_sym": 0,
    "p1_stiffness": 0,
    "element_matvec": 0,
    "csr_spmv": 0,
}

#: the CUDA sources under ``csrc/``, one shared library each
SOURCES = ("stencil", "p1_stiffness", "element_matvec", "csr_spmv")

#: the element sizes k that K5 is built for (``kBuiltK`` in
#: ``csrc/element_matvec.cu``; checked when the library loads)
ELEMENT_MATVEC_K = (3, 4, 6, 10, 12)

#: row-major upper-triangle index of the symmetric P1 element matrix:
#: SYM10[a][b] gives the slot of Ae[a, b] in the (10, nc) packed output of
#: ``p1_stiffness_sym`` (the slot order of the reference's ``SYM10``)
SYM10 = tuple(
    tuple(
        {(0, 0): 0, (0, 1): 1, (0, 2): 2, (0, 3): 3, (1, 1): 4,
         (1, 2): 5, (1, 3): 6, (2, 2): 7, (2, 3): 8, (3, 3): 9}[
            (min(a, b), max(a, b))
        ]
        for b in range(4)
    )
    for a in range(4)
)

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
    ci = ctypes.c_int
    lib.fst_stencil_apply.restype = ci
    lib.fst_stencil_apply.argtypes = [ci, vp, vp, vp, vp, i64, i64, i64, vp, vp]
    lib.fst_stencil_plan.restype = ci
    lib.fst_stencil_plan.argtypes = [ci, ci, ci, i64, i64, i64,
                                     ctypes.POINTER(ci)]
    lib.fst_stencil_offsets.restype = None
    lib.fst_stencil_offsets.argtypes = [ctypes.POINTER(ctypes.c_int)]
    table = (ctypes.c_int * 45)()
    lib.fst_stencil_offsets(table)
    if not np.array_equal(np.array(table[:]).reshape(15, 3), OFFSETS):
        raise RuntimeError("csrc/stencil.cu offset table differs from OFFSETS")
    _libs["stencil"] = lib
    return lib


def _p1_stiffness_lib():
    lib = _libs.get("p1_stiffness")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build("p1_stiffness"))
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    ci = ctypes.c_int
    for fn in ("fst_p1_stiffness_sym_f64", "fst_p1_stiffness_sym_f32"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [vp, vp, vp, i64, vp]
    for fn in ("fst_p1_stiffness_f64", "fst_p1_stiffness_f32"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [vp, vp, vp, i64, ci, ci, ci,
                      ctypes.POINTER(ctypes.c_double), ctypes.c_double, vp]
    _libs["p1_stiffness"] = lib
    return lib


def _element_matvec_lib():
    lib = _libs.get("element_matvec")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build("element_matvec"))
    vp = ctypes.c_void_p
    for fn in ("fst_element_matvec_f64", "fst_element_matvec_f32"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int, vp]
    lib.fst_element_matvec_built_k.restype = ctypes.c_int
    lib.fst_element_matvec_built_k.argtypes = [ctypes.POINTER(ctypes.c_int),
                                               ctypes.c_int]
    table = (ctypes.c_int * 16)()
    count = lib.fst_element_matvec_built_k(table, 16)
    if tuple(table[:count]) != ELEMENT_MATVEC_K:
        raise RuntimeError(
            f"csrc/element_matvec.cu is built for k in {tuple(table[:count])}, "
            f"ELEMENT_MATVEC_K says {ELEMENT_MATVEC_K}"
        )
    _libs["element_matvec"] = lib
    return lib


def _csr_spmv_lib():
    lib = _libs.get("csr_spmv")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build("csr_spmv"))
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    for fn in ("fst_csr_spmv_f64", "fst_csr_spmv_f32"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [vp, vp, vp, vp, vp, i64, i64, ctypes.c_int, vp]
    _libs["csr_spmv"] = lib
    return lib


def _device_kind(name, t):
    """"cpu" or "cuda" for the device of ``t``; raises on anything else."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _check_like(name, ref, **tensors):
    """Each of ``tensors`` is on the device of ``ref`` and of its dtype
    (float32 or float64), with fewer than 2^31 elements; on a CUDA device,
    also contiguous (the kernels take dense C-order arrays)."""
    if ref.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported dtype {ref.dtype}")
    for arg, t in tensors.items():
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(
                f"{name}: {arg} is {t.dtype} on {t.device}, expected "
                f"{ref.dtype} on {ref.device}"
            )
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: {arg} has 2^31 or more elements")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_lattice(name, x3, free3, **more):
    """The checks of the stencil wrappers: ``x3`` (Nx, Ny, Nz), ``free3``
    (optional) of its shape, ``more`` tensors alike (``_check_like``).
    Returns "cpu" or "cuda"."""
    kind = _device_kind(name, x3)
    if x3.dim() != 3:
        raise ValueError(f"{name}: x3 must be (Nx, Ny, Nz), got {tuple(x3.shape)}")
    if free3 is not None:
        if free3.shape != x3.shape:
            raise ValueError(f"{name}: free3 must have the shape of x3")
        more["free3"] = free3
    _check_like(name, x3, x3=x3, **more)
    return kind


def _aligned16(t):
    """``t``, or a copy of it where its data is not 16 B aligned (the
    stencil kernels copy x and f 16 B at a time)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


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
    if _check_lattice("stencil_apply_const", x3, free3) == "cpu":
        return stencil_apply_const_reference(x3, coefs, free3)
    return _stencil_launch("stencil_apply_const", x3, free3, None,
                           _taps(coefs))


# ---------------------------------------------------------------------------
# K1: variable-coefficient 15-tap stencil (lattice PCG operator)
# ---------------------------------------------------------------------------


def stencil_apply_var_reference(x3, coef, free3=None):
    """Plain PyTorch version: ``y[v] = sum_t coef[t, v] * x[v + d_t]`` with
    zero reads outside the lattice, or ``free3 * A(free3 * x3)`` with a
    mask.  Centre tap first, then the other taps in offset order, as the
    reference's lattice operator (``bench.py:587-592``) sums them."""
    xm = x3 if free3 is None else free3 * x3
    nx, ny, nz = xm.shape
    xp = F.pad(xm, (1, 1, 1, 1, 1, 1))
    y = coef[_CENTER_IDX] * xm
    for oi, (di, dj, dk) in enumerate(OFFSETS):
        if oi == _CENTER_IDX:
            continue
        y = y + coef[oi] * xp[
            1 + di : 1 + di + nx, 1 + dj : 1 + dj + ny, 1 + dk : 1 + dk + nz
        ]
    return y if free3 is None else free3 * y


def stencil_apply_var(x3, coef, free3=None):
    """Variable-coefficient 15-tap stencil, ``free3 * A(free3 * x3)`` (or
    ``A(x3)`` without a mask), ``A`` with per-vertex taps ``coef[t, v]``
    indexed by the output (row) vertex.

    ``x3``, ``free3``: (Nx, Ny, Nz); ``coef``: (15, Nx, Ny, Nz) aligned with
    ``ops/structured.OFFSETS``; one dtype, one device.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel of
    ``csrc/stencil.cu`` on the current stream.  Exact for any operand and
    mask (no zero-shell condition)."""
    if tuple(coef.shape) != (15,) + tuple(x3.shape):
        raise ValueError(
            "stencil_apply_var: coef must be (15, Nx, Ny, Nz) for x3 of shape "
            f"{tuple(x3.shape)}, got {tuple(coef.shape)}"
        )
    if _check_lattice("stencil_apply_var", x3, free3, coef=coef) == "cpu":
        return stencil_apply_var_reference(x3, coef, free3)
    return _stencil_launch("stencil_apply_var", x3, free3, coef, None)


def _stencil_launch(name, x3, free3, coef, taps):
    """K1 (``coef`` given) or K2 (host ``taps``) on checked CUDA tensors."""
    x3, free3 = _aligned16(x3), _aligned16(free3)
    y = torch.empty_like(x3)
    nx, ny, nz = x3.shape
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = _stencil_lib().fst_stencil_apply(
            int(x3.dtype == torch.float64), x3.data_ptr(),
            None if free3 is None else free3.data_ptr(),
            None if coef is None else coef.data_ptr(), y.data_ptr(),
            nx, ny, nz, None if taps is None else taps.ctypes.data, stream,
        )
    _launch(name, rc)
    return y


#: the fields of ``stencil_plan``, in the order ``csrc/stencil.cu`` writes
#: them
PLAN_FIELDS = ("threads", "outputs", "W", "R", "tiles", "chunk", "blocks",
               "smem_bytes")


def stencil_plan(x3, free3=None, coef=None):
    """The launch shape that K2 (``coef`` None) or K1 takes on the lattice
    of the CUDA tensor ``x3`` (masked when ``free3`` is given): a dict of
    ``PLAN_FIELDS`` (threads a block, outputs a thread, tile columns W and
    rows R, tiles a plane, planes a block, blocks, shared-memory bytes).
    Launches nothing."""
    if x3.device.type != "cuda" or x3.dtype not in (torch.float32,
                                                    torch.float64):
        raise ValueError("stencil_plan: x3 must be float32 or float64 on a "
                         f"CUDA device, got {x3.dtype} on {x3.device}")
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    with torch.cuda.device(x3.device):
        rc = _stencil_lib().fst_stencil_plan(
            int(x3.dtype == torch.float64), int(free3 is not None),
            int(coef is not None), *x3.shape, out)
    if rc != 0:
        raise RuntimeError(f"stencil_plan: failed with CUDA error {rc}")
    return dict(zip(PLAN_FIELDS, out[:]))


# ---------------------------------------------------------------------------
# K3 / K4: closed-form P1 element stiffness (structure of arrays)
# ---------------------------------------------------------------------------


def _check_stiffness(name, JinvT, detJ):
    kind = _device_kind(name, JinvT)
    if JinvT.dim() != 3 or tuple(detJ.shape) != (JinvT.shape[2],):
        raise ValueError(
            f"{name}: expected JinvT (tdim, gdim, nc) and detJ (nc,), got "
            f"{tuple(JinvT.shape)} and {tuple(detJ.shape)}"
        )
    _check_like(name, JinvT, JinvT=JinvT, detJ=detJ)
    return kind


def p1_stiffness_sym_reference(JinvT, detJ):
    """Plain PyTorch version of ``p1_stiffness_sym``: the scaled Gram of the
    Jinv rows and the zero row-sum identity, packed by ``SYM10``."""
    s = detJ * (1.0 / 6.0)
    r = JinvT
    g = {}
    for i in range(3):
        for j in range(i, 3):
            g[(i, j)] = (
                r[i, 0] * r[j, 0] + r[i, 1] * r[j, 1] + r[i, 2] * r[j, 2]
            ) * s
    rowsum = [
        g[(min(i, 0), max(i, 0))] + g[(min(i, 1), max(i, 1))]
        + g[(min(i, 2), max(i, 2))]
        for i in range(3)
    ]
    return torch.stack([
        rowsum[0] + rowsum[1] + rowsum[2],  # (0,0)
        -rowsum[0], -rowsum[1], -rowsum[2],  # (0,1) (0,2) (0,3)
        g[(0, 0)], g[(0, 1)], g[(0, 2)],  # (1,1) (1,2) (1,3)
        g[(1, 1)], g[(1, 2)], g[(2, 2)],  # (2,2) (2,3) (3,3)
    ])


def p1_stiffness_sym(JinvT, detJ):
    """Packed symmetric 3-D P1 stiffness: JinvT (3, 3, nc), detJ (nc,) ->
    (10, nc); ``SYM10[a][b]`` is the slot of Ae[a, b].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of ``csrc/p1_stiffness.cu`` on the current stream."""
    kind = _check_stiffness("p1_stiffness_sym", JinvT, detJ)
    if tuple(JinvT.shape[:2]) != (3, 3):
        raise ValueError(
            f"p1_stiffness_sym: JinvT must be (3, 3, nc), got {tuple(JinvT.shape)}"
        )
    if kind == "cpu":
        return p1_stiffness_sym_reference(JinvT, detJ)
    nc = JinvT.shape[2]
    if 10 * nc >= 2**31:
        raise ValueError("p1_stiffness_sym: output has 2^31 or more elements")
    out = torch.empty((10, nc), dtype=JinvT.dtype, device=JinvT.device)
    lib = _p1_stiffness_lib()
    fn = (
        lib.fst_p1_stiffness_sym_f64
        if JinvT.dtype == torch.float64
        else lib.fst_p1_stiffness_sym_f32
    )
    with torch.cuda.device(JinvT.device):
        stream = torch.cuda.current_stream(JinvT.device).cuda_stream
        rc = fn(JinvT.data_ptr(), detJ.data_ptr(), out.data_ptr(), nc, stream)
    _launch("p1_stiffness_sym", rc)
    return out


_VOL_FACT = {1: 1.0, 2: 2.0, 3: 6.0}


def _gref_host(JinvT, gref):
    g = np.ascontiguousarray(
        np.asarray(
            gref.detach().cpu().numpy() if torch.is_tensor(gref) else gref,
            dtype=np.float64,
        )
    )
    tdim, gdim = JinvT.shape[0], JinvT.shape[1]
    if not (1 <= tdim <= gdim <= 3):
        raise ValueError(
            f"p1_stiffness: needs 1 <= tdim <= gdim <= 3, got JinvT "
            f"{tuple(JinvT.shape)}"
        )
    if g.ndim != 2 or g.shape[1] != tdim or not 1 <= g.shape[0] <= 4:
        raise ValueError(
            f"p1_stiffness: gref must be (k, tdim) with k <= 4 and tdim = "
            f"{tdim}, got shape {g.shape}"
        )
    return g


def p1_stiffness_reference(JinvT, detJ, gref):
    """Plain PyTorch version of ``p1_stiffness``."""
    g_ref = _gref_host(JinvT, gref)
    k, tdim = g_ref.shape
    gdim = JinvT.shape[1]
    g = [
        [
            sum(float(g_ref[a, t]) * JinvT[t, d] for t in range(tdim))
            for d in range(gdim)
        ]
        for a in range(k)
    ]
    scale = detJ * (1.0 / _VOL_FACT[tdim])
    rows = []
    for a in range(k):
        for b in range(k):
            acc = g[a][0] * g[b][0]
            for d in range(1, gdim):
                acc = acc + g[a][d] * g[b][d]
            rows.append(acc * scale)
    return torch.stack(rows).reshape(k, k, -1)


def p1_stiffness(JinvT, detJ, gref):
    """Closed-form P1 stiffness: JinvT (tdim, gdim, nc), detJ (nc,), host
    reference gradients gref (k, tdim) -> (k, k, nc), with
    ``Ae[a, b] = (detJ / vol_fact) g[a] . g[b]`` and ``g = gref Jinv``.

    ``k <= 4`` and ``tdim <= gdim <= 3``; anything else raises.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel of
    ``csrc/p1_stiffness.cu`` on the current stream."""
    kind = _check_stiffness("p1_stiffness", JinvT, detJ)
    g_ref = _gref_host(JinvT, gref)
    if kind == "cpu":
        return p1_stiffness_reference(JinvT, detJ, g_ref)
    tdim, gdim, nc = JinvT.shape
    k = g_ref.shape[0]
    if k * k * nc >= 2**31:
        raise ValueError("p1_stiffness: output has 2^31 or more elements")
    out = torch.empty((k, k, nc), dtype=JinvT.dtype, device=JinvT.device)
    lib = _p1_stiffness_lib()
    fn = (
        lib.fst_p1_stiffness_f64
        if JinvT.dtype == torch.float64
        else lib.fst_p1_stiffness_f32
    )
    with torch.cuda.device(JinvT.device):
        stream = torch.cuda.current_stream(JinvT.device).cuda_stream
        rc = fn(
            JinvT.data_ptr(), detJ.data_ptr(), out.data_ptr(), nc, k, tdim,
            gdim, g_ref.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            1.0 / _VOL_FACT[tdim], stream,
        )
    _launch("p1_stiffness", rc)
    return out


# ---------------------------------------------------------------------------
# K5: batched element matvec (matrix-free operator, structure of arrays)
# ---------------------------------------------------------------------------


def element_matvec_reference(Ae_T, xe_T):
    """Plain PyTorch version of ``element_matvec``."""
    return torch.einsum("ijc,jc->ic", Ae_T, xe_T)


def element_matvec(Ae_T, xe_T):
    """``y_e = A_e x_e`` over a cell batch: Ae_T (k, k, nc), xe_T (k, nc) ->
    (k, nc), summed over j = 0..k-1 in order in the operands' dtype.

    ``k`` must be one of ``ELEMENT_MATVEC_K`` (the sizes the kernel is built
    for); anything else raises.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel of ``csrc/element_matvec.cu`` on the
    current stream."""
    kind = _device_kind("element_matvec", Ae_T)
    if Ae_T.dim() != 3 or Ae_T.shape[0] != Ae_T.shape[1] or (
        tuple(xe_T.shape) != (Ae_T.shape[0], Ae_T.shape[2])
    ):
        raise ValueError(
            f"element_matvec: expected Ae_T (k, k, nc) and xe_T (k, nc), got "
            f"{tuple(Ae_T.shape)} and {tuple(xe_T.shape)}"
        )
    k, _, nc = Ae_T.shape
    if k not in ELEMENT_MATVEC_K:
        raise ValueError(
            f"element_matvec: k = {k} is not built; the kernel is built for "
            f"k in {ELEMENT_MATVEC_K}"
        )
    _check_like("element_matvec", Ae_T, Ae_T=Ae_T, xe_T=xe_T)
    if kind == "cpu":
        return element_matvec_reference(Ae_T, xe_T)
    y = torch.empty_like(xe_T)
    if nc == 0:  # an empty shard: nothing to launch
        return y
    lib = _element_matvec_lib()
    fn = (
        lib.fst_element_matvec_f64
        if Ae_T.dtype == torch.float64
        else lib.fst_element_matvec_f32
    )
    with torch.cuda.device(Ae_T.device):
        stream = torch.cuda.current_stream(Ae_T.device).cuda_stream
        rc = fn(Ae_T.data_ptr(), xe_T.data_ptr(), y.data_ptr(), nc, k, stream)
    _launch("element_matvec", rc)
    return y


# ---------------------------------------------------------------------------
# csr_spmv: fixed-order CSR product (the AMG V-cycles; repairs F5)
# ---------------------------------------------------------------------------


def csr_spmv_reference(indptr, indices, data, x, shape):
    """Plain PyTorch version of ``csr_spmv``: PyTorch's CSR product."""
    from ..la.sparse import sparse_csr

    return sparse_csr(indptr, indices, data, tuple(shape)) @ x


#: the group sizes ``csr_spmv`` is built for (threads a row)
SPMV_LANES = (4, 8, 16, 32)


def spmv_lanes(nnz, n_rows, cols=1):
    """The threads a row of ``csr_spmv`` for a matrix of ``nnz`` entries in
    ``n_rows`` rows times ``cols`` columns: the smallest of ``SPMV_LANES``
    whose threads sum at least ~8 entries each over the row's columns
    (``8 * lanes * cols >= nnz / n_rows``), else 32.  On the H100 this was
    the fastest group at 43.5, 82 and 183 entries a row (the cantilever's
    AMG level 0 A, P and R), and 4 for a block of 6 columns (PERF.md)."""
    mean = nnz / max(n_rows, 1)
    return next((v for v in SPMV_LANES if 8 * v * cols >= mean),
                SPMV_LANES[-1])


def csr_spmv(indptr, indices, data, x, shape, lanes=None):
    """``y = A @ x`` for the CSR matrix ``A`` (``indptr``, ``indices``,
    ``data``, ``shape`` = (rows, cols)) and ``x`` a vector (cols,) or a
    block of columns (cols, m); ``y`` is (rows,) or (rows, m).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of ``csrc/csr_spmv.cu`` on the current stream, which sums each row in an
    order fixed by the matrix and the column count (and ``lanes``, the
    threads a row, by default ``spmv_lanes`` of them), so equal inputs give
    equal bits.  On the
    card ``indptr`` and ``indices`` must be int32 and ``data`` of ``x``'s
    dtype (float32 or float64); ``x`` is made contiguous."""
    n_rows, n_cols = (int(v) for v in shape)
    if x.dim() not in (1, 2) or x.shape[0] != n_cols:
        raise ValueError(
            f"csr_spmv: x must be ({n_cols},) or ({n_cols}, m), got "
            f"{tuple(x.shape)}"
        )
    if tuple(indptr.shape) != (n_rows + 1,) or indices.shape != data.shape:
        raise ValueError(
            f"csr_spmv: indptr must be ({n_rows + 1},) and indices like data, "
            f"got {tuple(indptr.shape)}, {tuple(indices.shape)}, "
            f"{tuple(data.shape)}"
        )
    m = 1 if x.dim() == 1 else int(x.shape[1])
    lanes = (spmv_lanes(data.numel(), n_rows, m) if lanes is None
             else int(lanes))
    if lanes not in SPMV_LANES:
        raise ValueError(f"csr_spmv: lanes must be one of {SPMV_LANES}, "
                         f"not {lanes}")
    if _device_kind("csr_spmv", x) == "cpu":
        _check_like("csr_spmv", x, data=data)
        return csr_spmv_reference(indptr, indices, data, x, shape)
    x = x.contiguous()
    _check_like("csr_spmv", x, x=x, data=data)
    for arg, t in (("indptr", indptr), ("indices", indices)):
        if t.dtype != torch.int32 or t.device != x.device:
            raise ValueError(
                f"csr_spmv: {arg} is {t.dtype} on {t.device}, expected "
                f"int32 on {x.device}"
            )
    if n_rows * m * 32 >= 2**31:
        raise ValueError("csr_spmv: rows * columns * 32 reaches 2^31")
    y = torch.empty((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if n_rows * m == 0:
        return y
    lib = _csr_spmv_lib()
    fn = lib.fst_csr_spmv_f64 if x.dtype == torch.float64 else lib.fst_csr_spmv_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
                x.data_ptr(), y.data_ptr(), n_rows, m, lanes, stream)
    _launch("csr_spmv", rc)
    return y
