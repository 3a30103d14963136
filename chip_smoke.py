#!/usr/bin/env python3
"""GPU smoke run of fenicssolver_tpu_torch: the quickest proof that the
port builds and runs its main path on an NVIDIA card.

Run from the repository root on a machine with one CUDA device (H100,
sm_90a) and ``nvcc``:

    python3 chip_smoke.py

Phases (each prints its findings on its own line; any failure exits
non-zero and no result line is printed):

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build: the CUDA sources under ``fenicssolver_tpu_torch/csrc/`` for
   sm_90a, one nvcc per source, all started together;
3. K2 (``stencil_apply_const``) against its plain PyTorch version over
   ``STENCIL_SHAPES`` (the GMG level shapes 129^3 .. 17^3 and shapes that
   end mid-tile and mid-chunk), each of no mask, free sides,
   all-Dirichlet and a random mask, f64 and f32, at ``TOL``; then timed
   at 129^3 with CUDA events, L2 flushed and warm, beside its bound and
   ``F.conv3d`` (the unmasked apply, the library yardstick);
4. K1 (``stencil_apply_var``) likewise with random tap fields (no single
   PyTorch call computes it);
5. K3 (``p1_stiffness_sym``) and K4 (``p1_stiffness``) likewise at
   6 * 128^3 = 12,582,912 cells with random well-conditioned Jacobians,
   K4 also with the 2-D reference gradients (k = 3);
5b. default device: with ``FST_DEVICE`` unset, ``run_stencil(16)`` and
   the lattice CLI run on ``cuda:0`` through K1;
6. steady heat path: ``main(settings)`` on ``UnitCubeMesh(128)``
   (2,146,689 dofs), f64, GMG-preconditioned CG at rtol 1e-10, with phase
   times, iterations, the K2 launch count and the peak device memory; then
   the solve's V-cycle: wall and device-busy time a cycle, K2's part, and
   per level K2's device time a launch and host time a call;
6b. main path (transient): ``main(settings)`` on the same mesh and space,
   three Crank-Nicolson steps of 1e-3 of the decaying sine mode on
   T = 300 + 60 z (Dirichlet on every face), GMG-CG at rtol 1e-10 each
   step, the cached transient form from step 2; one line a step (form build
   or refresh, assembly, GMG setup, Krylov, iterations, K2 launches); checks
   the CN decay to 1e-2, <= 60 iterations and K2 on every step;
6c. SUPG advection at n = 48 (BiCGStab, or GMRES after a breakdown) against
   the exact exponential profile to 1e-3;
6d. Newton at n = 48: k(T) against its closed form to 2e-5; radiation with
   a point source (and the same at n = 12 on the card and the CPU, 1e-8);
6e. saving: one transient step at n = 16 with ``saving_freq: 1``; the PVD
   and VTU parse and hold T; then a transient copy of the JSON case, P1 and
   P2, through ``python -m fenicssolver_tpu_torch`` with ``FST_DEVICE``
   unset runs on the card;
7. a body-source case at n=32 whose CUDA solve must match the CPU solve;
8. the bundled JSON case ``data/TestHeatTransfer.json`` on the card;
9. lattice path: ``lattice_poisson.run_stencil(128)`` (the port of
   ``bench.py``'s structured-lattice Poisson solve, 2,146,689 dofs, K3
   assembly, K1 operator, GMG-CG to 1e-6) in f32 and f64, held to the
   same-size CPU mirror's u_max; the three assembly modes' fields agree;
10. CSR path: ``lattice_poisson.run_csr(96)`` (K4 assembly into CSR)
    against ``run_stencil(96)``, in f64: K4's f32 element matrices lose the
    exact zero row sums that K3's packing keeps, which moves the f32
    solution by ~cond(A) * eps (1.5e-4 relative at n = 64 on the CPU);
11. K5 (``element_matvec``) against its plain version with seeded random
    operands, f64 and f32, at k = 4, nc = 6 * 128^3 (the Poisson path's
    size) and k = 12, nc = 6 * 64^3;
12. sharded path: ``parallel.ShardedEllipticSolver`` (cell-sharded,
    matrix-free, K5 operator, Jacobi-PCG) on (a) the dry run's
    ``poisson3d_p1`` at ``UnitCubeMesh(128)`` (2,146,689 dofs), f64, one
    shard, tol 1e-10, held to ``run_stencil(128, tol=1e-10)`` in f64 (the
    same discrete problem: the mesh's vertices are the lattice's in
    C-order); (b) ``elasticity3d_p1`` at ``UnitCubeMesh(32)`` (107,811
    dofs, k = 12) against the port's assembled CSR Jacobi-CG; (c)
    ``poisson3d_p1`` at n = 32 on four shards of ``cuda:0`` against one.

Kernel times in the kernels' record are those of the dtype and mask of
the path that launches the kernel: K2 f64 all-Dirichlet (the transient
heat path, whose launches the record counts),
K1 (all-Dirichlet mask) and K3 f32 (the lattice path, in the bench's
dtype), K4 f64 (the CSR path), K5 f64 at k = 4 (the sharded Poisson path).
``ms``, ``plain_ms`` and ``library_ms`` are medians with the L2 flushed
before each run; ``bound_ms`` is the larger of the modelled bytes (each
input read once, each output written once: ``k1_bytes`` .. ``k5_bytes``)
over ``HBM_BYTES_PER_S`` and the operations over ``PEAK_FLOPS``.
``library_case`` says what ``library_ms`` times and ``library_kernel_ms``
is the kernel on that same case: for K2, ``F.conv3d`` on the same x,
which computes the unmasked apply (so it stands beside the unmasked
kernel, not the masked ``ms``); for K5, the ``einsum`` of its plain
version on the same case; K1, K3 and K4 have no single PyTorch call
(null, with the reason).

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

N_MAIN = 128
RTOL = 1e-10
#: kernel vs plain version: max abs error over the plain version's max abs
TOL = {"float64": 1e-12, "float32": 1e-5}
#: H100 SXM data sheet: HBM3 rate, and peak rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
#: scratch written before each flushed timing: 5x the 50 MB L2
L2_FLUSH_BYTES = 256 * 2**20
#: device busy-wait before each warm timing: ~0.1 ms at the H100's clock
SLEEP_CYCLES = 200_000
_l2_scratch = None
#: K1/K2 sweep: the GMG level shapes at n = 128, and shapes that end
#: mid-tile in every axis and mid-chunk in i
STENCIL_SHAPES = ((129, 129, 129), (65, 65, 65), (33, 33, 33), (17, 17, 17),
                  (5, 7, 300), (2, 2, 2), (130, 3, 33))
KERNELS = {  # name: (source, TPU kernel it replaces)
    "stencil_apply_var": ("fenicssolver_tpu_torch/csrc/stencil.cu",
                          "fenicssolver_tpu/ops/pallas_kernels.py:308"),
    "stencil_apply_const": ("fenicssolver_tpu_torch/csrc/stencil.cu",
                            "fenicssolver_tpu/ops/pallas_kernels.py:363"),
    "p1_stiffness_sym": ("fenicssolver_tpu_torch/csrc/p1_stiffness.cu",
                         "fenicssolver_tpu/ops/pallas_kernels.py:144"),
    "p1_stiffness": ("fenicssolver_tpu_torch/csrc/p1_stiffness.cu",
                     "fenicssolver_tpu/ops/pallas_kernels.py:74"),
    "element_matvec": ("fenicssolver_tpu_torch/csrc/element_matvec.cu",
                       "fenicssolver_tpu/ops/pallas_kernels.py:28"),
}
#: u_max of the same problem (n = 128, tol 1e-6) from the same-algorithm
#: f64 CPU mirror of the JAX package's bench (``bench.py:155-156``)
U_MAX_128 = 0.05620760176173512
N_CSR = 96  # the JAX bench's size for its assembled-matrix format
N_ELAS = 32  # sharded elasticity: 107,811 dofs, k = 12
N_FOUR = 32  # mesh size of the four-shard Poisson check


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def heat_settings(core, V, body_source=None):
    """The GMG heat case of tests/test_gmg.py on the P1 space V of a
    UnitCubeMesh: T = 360 on z = 1, T = 300 on z = 0, natural side walls."""
    top = core.AutoSubDomain(lambda x: core.near(x[2], 1.0))
    bottom = core.AutoSubDomain(lambda x: core.near(x[2], 0.0))
    s = {
        "solver_name": "ScalarTransportSolver",
        "scalar_name": "temperature", "function_space": V, "mesh": None,
        "boundary_conditions": {
            "hot": {"boundary": top, "boundary_id": 1,
                    "type": "Dirichlet", "value": 360.0},
            "cold": {"boundary": bottom, "boundary_id": 2,
                     "type": "Dirichlet", "value": 300.0},
        },
        "material": {"density": 1000, "specific_heat_capacity": 4200,
                     "thermal_conductivity": 0.6},
        "solver_settings": {
            "transient_settings": {"transient": False},
            "reference_values": {},
            "solver_parameters": {"relative_tolerance": RTOL,
                                  "maximum_iterations": 3000,
                                  "preconditioner": "gmg"},
        },
        "report_settings": {"logging_level": 40},
    }
    if body_source is not None:
        s["body_source"] = body_source
    return s


def time_ms(fn, reps=25, warmup=3, flush=False):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events).

    Before each timed run, outside the events, the device is kept busy
    while the host enqueues ``fn`` (so the time is the device's, not the
    launch overhead's): with ``flush``, by writing and then reading a
    scratch tensor of ``L2_FLUSH_BYTES``, so that ``fn`` finds its operands
    in device memory and not in the 50 MB L2, and the L2 holds clean lines
    (no write-back of the scratch inside the timed run); else by a
    busy-wait that leaves L2 warm."""
    import torch

    global _l2_scratch
    if flush and _l2_scratch is None:
        _l2_scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        # keep the device busy while the host enqueues fn, so the events
        # time the device's work and not the launch overhead
        if flush:
            _l2_scratch.fill_(1)
            _l2_scratch.max()  # leaves L2 holding clean lines of the scratch
        else:
            torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# -- byte and operation models: each input byte read once, each output
# -- byte written once, and the operations on those inputs


def k2_bytes(shape, itemsize, masked=True):
    """K2: x (and the mask f) read, y written."""
    return (3 if masked else 2) * math.prod(shape) * itemsize


def k1_bytes(shape, itemsize, masked=True):
    """K1: the 15 coefficient fields and x (and f) read, y written."""
    return (15 + (3 if masked else 2)) * math.prod(shape) * itemsize


def stencil_flops(shape, masked=True):
    """K1/K2 per vertex: 15 products and 14 sums, and with a mask f * x
    once and the final f * sum."""
    return (31 if masked else 29) * math.prod(shape)


def k3_bytes(nc, itemsize):
    """K3: JinvT (9) and detJ (1) read, the 10 packed entries written."""
    return (9 + 1 + 10) * nc * itemsize


def k3_flops(nc):
    """K3 per cell: 6 scaled dot products of 3, the scale, 3 row sums of 3
    and their sum."""
    return (6 * 6 + 1 + 3 * 2 + 2) * nc


def k4_bytes(nc, itemsize, dim=3, k=4):
    """K4: JinvT (dim^2) and detJ (1) read, the k^2 entries written."""
    return (dim * dim + 1 + k * k) * nc * itemsize


def k4_flops(nc, dim=3, k=4):
    """K4 per cell: g = gref Jinv (k * dim dot products of dim), the k^2
    scaled dot products of dim, the scale."""
    return (k * dim * (2 * dim - 1) + k * k * 2 * dim + 1) * nc


def k5_bytes(nc, itemsize, k=4):
    """K5: A (k^2) and x (k) read, y (k) written."""
    return (k * k + 2 * k) * nc * itemsize


def k5_flops(nc, k=4):
    return (2 * k * k - k) * nc


def bound(nbytes, flops, dtype_name):
    """(ms, "bytes" or "operations"): the larger of bytes over the HBM rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"using {torch.cuda.get_device_name(0)}")
    return card


def _ptxas_lines(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: entry function,
    registers, spills, shared memory."""
    name, out = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def phase_build():
    from fenicssolver_tpu_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cuda_kernels.SOURCES)) as ex:
        paths = list(ex.map(cuda_kernels.build, cuda_kernels.SOURCES))
    print(f"[build] {len(paths)} sources in {time.perf_counter() - t0:.2f} s")
    for name, path in zip(cuda_kernels.SOURCES, paths):
        info = cuda_kernels.BUILD_INFO[name]
        print(f"[build] {os.path.relpath(path, HERE)} (nvcc {info['seconds']:.2f} s)")
        for line in _ptxas_lines(info["log"]):
            print(f"[build] {line}")
    from fenicssolver_tpu_torch import native

    print("[build] host helpers native/fst_native.cpp: "
          + ("built with g++" if native.available() else "numpy fallbacks"))


def stencil_masks(shape, seed=0):
    """(name, 0/1 mask or None) of the stencil sweep: no mask, free sides
    (Dirichlet on the two k faces only, the heat path's kind), all-Dirichlet
    (the whole shell, the lattice path's), and a random mask."""
    import numpy as np

    sides = np.ones(shape)
    sides[:, :, 0] = sides[:, :, -1] = 0.0
    closed = np.zeros(shape)
    closed[1:-1, 1:-1, 1:-1] = 1.0
    rand = (np.random.default_rng(seed).random(shape) < 0.5).astype(np.float64)
    return (("no mask", None), ("free-sides", sides),
            ("all-dirichlet", closed), ("random", rand))


def _agree(tag, what, kernel, plain, tol):
    """Kernel against plain version on the same inputs; returns the max abs
    error.  The kernel's output is allocated right after a NaN-filled block
    of its size is freed, so an output the kernel misses most likely shows
    as NaN (and fails)."""
    import torch

    y_p = plain()
    poison = torch.full_like(y_p, float("nan"))
    del poison
    y_k = kernel()
    torch.cuda.synchronize()
    abs_err = float((y_k - y_p).abs().max())
    scale = float(y_p.abs().max())
    rel = abs_err / scale if scale > 0 else abs_err
    check(rel <= tol, f"{tag} {what}: max abs err {abs_err}, rel {rel} > {tol}")
    return abs_err, rel


def _timed(tag, what, kernel, plain, nbytes, flops, dtype_name, library=None):
    """CUDA-event times of the kernel (L2 flushed and warm), its plain
    version and, where given, the library call (both flushed), beside the
    bound; printed and returned."""
    ms = time_ms(kernel, flush=True)
    warm = time_ms(kernel)
    plain_ms = time_ms(plain, flush=True)
    lib_ms = None if library is None else time_ms(library, flush=True)
    bound_ms, by = bound(nbytes, flops, dtype_name)
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    print(f"[{tag}] {what}: kernel {ms:.4f} ms flushed ({warm:.4f} ms warm), "
          f"bound {bound_ms:.4f} ms ({by}, {nbytes:,} B), "
          f"{100 * bound_ms / ms:.1f}% of the bound flushed; plain "
          f"{plain_ms:.4f} ms{lib}")
    return {"ms": ms, "warm_ms": warm, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}


def plan_text(plan):
    return (f"{plan['threads']} threads x {plan['outputs']} outputs, tile "
            f"{plan['R']} x {plan['W']} (j x k), {plan['tiles']} tiles a plane, "
            f"{plan['chunk']} planes a block, {plan['blocks']} blocks, "
            f"{plan['smem_bytes']} B shared")


def _misaligned(t):
    """A copy of ``t`` whose data starts one element past a 16 B boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _stencil_sweep(tag, shapes, device, kernel, plain, plan, operands):
    """Each shape, f64 and f32, each mask of ``stencil_masks``: kernel
    against plain version at ``TOL``; one line per shape and type.
    ``operands(shape, dtype)`` gives the inputs after x; returns the max
    abs error in each type."""
    import numpy as np
    import torch

    worst = {"float64": 0.0, "float32": 0.0}
    for shape in shapes:
        x_np = np.random.default_rng(len(shape) + sum(shape)).standard_normal(shape)
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).replace("torch.", "")
            x = torch.as_tensor(x_np, dtype=dtype, device=device)
            more = operands(shape, dtype)
            errs = []
            for mname, m_np in stencil_masks(shape, seed=sum(shape)):
                f = None if m_np is None else torch.as_tensor(
                    m_np, dtype=dtype, device=device)
                err, rel = _agree(tag, f"{name} {mname} {shape}",
                                  lambda: kernel(x, *more, f),
                                  lambda: plain(x, *more, f), TOL[name])
                worst[name] = max(worst[name], err)
                errs.append(f"{mname} {rel:.1e}")
            # operands off the 16 B alignment the kernels copy at
            xm, fm = _misaligned(x), _misaligned(f)
            _, rel = _agree(tag, f"{name} misaligned {shape}",
                            lambda: kernel(xm, *more, fm),
                            lambda: plain(x, *more, f), TOL[name])
            errs.append(f"random misaligned {rel:.1e}")
            p = plan(x, *more, f)
            print(f"[{tag}] {name} {shape}: rel err {', '.join(errs)} "
                  f"(tol {TOL[name]:g}); {plan_text(p)}")
            del x, more
    return worst


def phase_k2(device="cuda", shapes=STENCIL_SHAPES):
    """K2 against its plain version over the GMG level shapes and shapes
    that end mid-tile and mid-chunk, every mask, f64 and f32; then
    ``time_k2``."""
    from fenicssolver_tpu_torch.la import gmg
    from fenicssolver_tpu_torch.ops import cuda_kernels

    coefs = gmg.p1_box_stencil(1.0 / N_MAIN, 1.0 / N_MAIN, 1.0 / N_MAIN)
    worst = _stencil_sweep(
        "k2", shapes, device,
        lambda x, f: cuda_kernels.stencil_apply_const(x, coefs, f),
        lambda x, f: cuda_kernels.stencil_apply_const_reference(x, coefs, f),
        lambda x, f: cuda_kernels.stencil_plan(x, f),
        lambda shape, dtype: ())
    return {**time_k2(device), "max_abs_err": worst["float64"]}


def time_k2(device="cuda", n=N_MAIN):
    """K2 timed at (n + 1)^3, f64 and f32, free sides, all-Dirichlet and
    unmasked, beside its bound; the unmasked apply also beside
    ``F.conv3d``, which computes that function (checked against the plain
    version first).  Calls only the wrappers, which every version of the
    package has.  Returns the f64 all-Dirichlet times (the transient heat
    path's case: Dirichlet on every face), with the library time and the
    kernel's on the library's case."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from fenicssolver_tpu_torch.la import gmg
    from fenicssolver_tpu_torch.ops import cuda_kernels
    from fenicssolver_tpu_torch.ops.structured import OFFSETS

    coefs = gmg.p1_box_stencil(1.0 / n, 1.0 / n, 1.0 / n)
    shape = (n + 1,) * 3
    x_np = np.random.default_rng(0).standard_normal(shape)
    masks = dict(stencil_masks(shape))
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        x = torch.as_tensor(x_np, dtype=dtype, device=device)
        w = torch.zeros((1, 1, 3, 3, 3), dtype=dtype, device=device)
        for t, (di, dj, dk) in enumerate(OFFSETS):
            w[0, 0, di + 1, dj + 1, dk + 1] = float(coefs[t])

        def conv():
            return F.conv3d(x[None, None], w, padding=1)[0, 0]

        _agree("k2", f"{name} F.conv3d (library)", conv,
               lambda: cuda_kernels.stencil_apply_const_reference(x, coefs),
               TOL[name])
        for mname in ("free-sides", "all-dirichlet", "no mask"):
            f = None if masks[mname] is None else torch.as_tensor(
                masks[mname], dtype=dtype, device=device)
            t = _timed(
                "k2", f"{name} {mname} {shape}",
                lambda: cuda_kernels.stencil_apply_const(x, coefs, f),
                lambda: cuda_kernels.stencil_apply_const_reference(x, coefs, f),
                k2_bytes(shape, x.element_size(), f is not None),
                stencil_flops(shape, f is not None), name,
                library=conv if f is None else None)
            if name == "float64" and mname == "all-dirichlet":
                out.update(t)
            if name == "float64" and mname == "no mask":
                out["library_ms"] = t["library_ms"]
                out["library_kernel_ms"] = t["ms"]
                out["library_case"] = (
                    f"F.conv3d: the unmasked apply, f64 {shape}; "
                    "library_kernel_ms is the kernel on that case")
        # the card's own rate at this size: a device copy that reads half
        # of the masked apply's bytes and writes the other half
        nbytes = k2_bytes(shape, x.element_size())
        a = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        b = torch.empty_like(a)
        ms = time_ms(lambda: b.copy_(a), flush=True)
        print(f"[k2] {name}: a device copy of {nbytes // 2:,} B ({nbytes:,} B "
              f"moved) takes {ms:.4f} ms flushed, {nbytes / ms / 1e9:.3f} TB/s")
        del x, w, a, b
    return out


def phase_k1(device="cuda", shapes=STENCIL_SHAPES):
    """K1 against its plain version over the same shapes, masks and types
    as K2, with random tap fields; then ``time_k1``."""
    from fenicssolver_tpu_torch.ops import cuda_kernels

    worst = _stencil_sweep(
        "k1", shapes, device, cuda_kernels.stencil_apply_var,
        cuda_kernels.stencil_apply_var_reference,
        lambda x, c, f: cuda_kernels.stencil_plan(x, f, c),
        lambda shape, dtype: _k1_coef(shape, dtype, device))
    return {**time_k1(device), "max_abs_err": worst["float32"]}


def _k1_coef(shape, dtype, device="cuda"):
    """Seeded random tap fields (15,) + shape for K1."""
    import numpy as np
    import torch

    c = np.random.default_rng(sum(shape) + 1).standard_normal((15,) + shape)
    return (torch.as_tensor(c, dtype=dtype, device=device),)


def time_k1(device="cuda", n=N_MAIN):
    """K1 timed at (n + 1)^3, f32 and f64, all-Dirichlet and unmasked,
    beside its bound (no single PyTorch call computes it: the taps differ
    at each vertex).  Calls only the wrappers.  Returns the f32
    all-Dirichlet times (the lattice path's case)."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels

    shape = (n + 1,) * 3
    x_np = np.random.default_rng(1).standard_normal(shape)
    masks = dict(stencil_masks(shape))
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        x = torch.as_tensor(x_np, dtype=dtype, device=device)
        (coef,) = _k1_coef(shape, dtype, device)
        for mname in ("all-dirichlet", "no mask"):
            f = None if masks[mname] is None else torch.as_tensor(
                masks[mname], dtype=dtype, device=device)
            t = _timed(
                "k1", f"{name} {mname} {shape}",
                lambda: cuda_kernels.stencil_apply_var(x, coef, f),
                lambda: cuda_kernels.stencil_apply_var_reference(x, coef, f),
                k1_bytes(shape, x.element_size(), f is not None),
                stencil_flops(shape, f is not None), name)
            if name == "float32" and mname == "all-dirichlet":
                out.update(t, library_case="none: the taps differ at each vertex",
                           library_kernel_ms=None)
        del x, coef, f
    return out


def _compare(tag, what, kernel, plain, nbytes, flops, dtype_name, tol,
             library=False):
    """Kernel against plain version on the same inputs, then ``_timed``;
    ``library``: the plain version is itself one PyTorch call (its time is
    also the library time).  Returns ``_timed``'s dict with the max abs
    error."""
    abs_err, _ = _agree(tag, what, kernel, plain, tol)
    t = _timed(tag, what, kernel, plain, nbytes, flops, dtype_name)
    if library:
        t.update(library_ms=t["plain_ms"], library_kernel_ms=t["ms"],
                 library_case="the plain version, one torch.einsum; same case")
    else:
        t.update(library_kernel_ms=None,
                 library_case="none: no single PyTorch call computes it")
    return {"max_abs_err": abs_err, **t}


def _random_geometry(nc, dim, device):
    """JinvT (dim, dim, nc) and detJ (nc,) of random well-conditioned
    Jacobians J = rand + 2I (seeded), inverted in closed form on the card."""
    import torch

    gen = torch.Generator(device=device).manual_seed(dim)
    J = torch.rand((dim, dim, nc), generator=gen, dtype=torch.float64,
                   device=device)
    J += 2.0 * torch.eye(dim, dtype=torch.float64, device=device)[:, :, None]
    if dim == 2:
        det = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
        adj = torch.stack([torch.stack([J[1, 1], -J[0, 1]]),
                           torch.stack([-J[1, 0], J[0, 0]])])
    else:
        # adj[i][j] = cofactor(j, i)
        def cof(r, c):
            rr = [a for a in range(3) if a != r]
            cc = [b for b in range(3) if b != c]
            m = (J[rr[0], cc[0]] * J[rr[1], cc[1]]
                 - J[rr[0], cc[1]] * J[rr[1], cc[0]])
            return m if (r + c) % 2 == 0 else -m

        adj = torch.stack([torch.stack([cof(j, i) for j in range(3)])
                           for i in range(3)])
        det = (J[0, 0] * cof(0, 0) + J[0, 1] * cof(0, 1)
               + J[0, 2] * cof(0, 2))
    return (adj / det).contiguous(), det.abs()


def phase_k3_k4(device="cuda", n=N_MAIN):
    """K3 and K4 against their plain versions at the lattice path's cell
    count; K4 also in 2-D (k = 3)."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels
    from fenicssolver_tpu_torch.ops.stencil_assembly import GREF_P1_3D

    nc = 6 * n**3
    gref2 = np.array([[-1.0, -1], [1, 0], [0, 1]])
    out = {}
    for dim, gref in ((3, GREF_P1_3D), (2, gref2)):
        JinvT64, detJ64 = _random_geometry(nc, dim, device)
        k = gref.shape[0]
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).replace("torch.", "")
            JinvT, detJ = JinvT64.to(dtype), detJ64.to(dtype)
            item = JinvT.element_size()
            cases = [("p1_stiffness", f"K4 {dim}-D k={k}",
                      lambda: cuda_kernels.p1_stiffness(JinvT, detJ, gref),
                      lambda: cuda_kernels.p1_stiffness_reference(JinvT, detJ,
                                                                  gref),
                      k4_bytes(nc, item, dim, k), k4_flops(nc, dim, k))]
            if dim == 3:
                cases.insert(0, (
                    "p1_stiffness_sym", "K3",
                    lambda: cuda_kernels.p1_stiffness_sym(JinvT, detJ),
                    lambda: cuda_kernels.p1_stiffness_sym_reference(JinvT, detJ),
                    k3_bytes(nc, item), k3_flops(nc)))
            for kname, what, kern, plain, nbytes, flops in cases:
                r = _compare("k3" if kname == "p1_stiffness_sym" else "k4",
                             f"{what} {name} nc={nc}", kern, plain, nbytes,
                             flops, name, TOL[name])
                # the dtype of the path that launches it (module docstring)
                path_dtype = "float32" if kname == "p1_stiffness_sym" else "float64"
                if name == path_dtype and dim == 3:
                    out[kname] = r
            del JinvT, detJ
        del JinvT64, detJ64
    return out


def _lattice_line(tag, r, peak):
    t = r["assembly_s"] + r["solve_s"]
    print(f"[{tag}] {r['format']} n={r['n']} {r['dtype']} assembly "
          f"{r['assembly']}: {r['ndof']} dofs, {r['iterations']} CG iterations, "
          f"rel residual {r['relres']:.3e}, u_max {r['u_max']:.10f}; setup "
          f"{r['setup_s'] * 1e3:.1f} ms, assembly {r['assembly_s'] * 1e3:.2f} ms, "
          f"solve {r['solve_s'] * 1e3:.2f} ms, {r['ndof'] / t:.4g} dofs/s; "
          f"peak device memory {peak:.2f} GiB")


def _peak_gib():
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def phase_lattice(device="cuda", n=N_MAIN):
    """The structured-lattice Poisson path, ``run_stencil(n)``, f32 then f64
    (each run reset and read its own launch counts), a warm f32 repeat,
    and the three assembly modes' fields on the card."""
    import torch

    from fenicssolver_tpu_torch.lattice_poisson import run_stencil
    from fenicssolver_tpu_torch.ops import cuda_kernels
    from fenicssolver_tpu_torch.ops.stencil_assembly import (
        MODES,
        assemble_stencil,
        box_geometry,
    )

    launches = None
    for dtype in (torch.float32, torch.float64, torch.float32):
        torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        r = run_stencil(n, tol=1e-6, assembly="sym", dtype=dtype, device=device)
        counts = dict(cuda_kernels.LAUNCHES)
        launches = launches or counts  # the first (f32) run's counts
        _lattice_line("lattice", r, _peak_gib())
        print(f"[lattice] launches: {counts}")
        rel = abs(r["u_max"] - U_MAX_128) / U_MAX_128 if n == N_MAIN else 0.0
        check(r["ndof"] == (n + 1) ** 3, f"ndof {r['ndof']}")
        check(r["iterations"] <= 10, f"{r['iterations']} CG iterations > 10")
        check(rel <= 1e-5, f"u_max {r['u_max']} vs the CPU mirror's "
              f"{U_MAX_128}: rel {rel}")
        for k in ("stencil_apply_var", "stencil_apply_const", "p1_stiffness_sym"):
            check(counts[k] > 0, f"{k} was not launched on the lattice path")
        del r
    JinvT, detJ = box_geometry((n, n, n), dtype=torch.float32, device=device)
    fields = {m: assemble_stencil(JinvT, detJ, (n, n, n), mode=m) for m in MODES}
    c0, b0 = fields["sym"]
    for m in MODES[1:]:
        c, b = fields[m]
        rel_c = float((c - c0).abs().max() / c0.abs().max())
        rel_b = float((b - b0).abs().max() / b0.abs().max())
        print(f"[lattice] f32 fields {m} vs sym: coef rel {rel_c:.3e}, "
              f"b3 rel {rel_b:.3e} (tol 1e-5)")
        check(rel_c <= 1e-5 and rel_b <= 1e-5, f"assembly {m} vs sym")
    return {"launches": launches}


def phase_csr(device="cuda", n=N_CSR):
    """``run_csr(n)`` (K4 into CSR) against ``run_stencil(n)``, f64."""
    import torch

    from fenicssolver_tpu_torch.lattice_poisson import run_csr, run_stencil
    from fenicssolver_tpu_torch.ops import cuda_kernels

    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    rc = run_csr(n, tol=1e-6, dtype=torch.float64, device=device)
    launches = dict(cuda_kernels.LAUNCHES)
    _lattice_line("csr", rc, _peak_gib())
    print(f"[csr] launches: {launches}")
    rs = run_stencil(n, tol=1e-6, dtype=torch.float64, device=device)
    rel = abs(rc["u_max"] - rs["u_max"]) / rs["u_max"]
    print(f"[csr] vs run_stencil({n}): {rs['iterations']} iterations, u_max "
          f"{rs['u_max']:.10f}, rel {rel:.3e} (tol 1e-5)")
    check(rel <= 1e-5, f"csr u_max rel {rel}")
    check(abs(rc["iterations"] - rs["iterations"]) <= 1,
          f"iterations {rc['iterations']} vs {rs['iterations']}")
    check(launches["p1_stiffness"] > 0, "K4 was not launched on the CSR path")
    return {"launches": launches}


def phase_k5(device="cuda", sizes=((4, 6 * N_MAIN**3), (12, 6 * 64**3))):
    """K5 against its plain version at the sharded paths' sizes: k = 4 at
    the Poisson path's cell count and k = 12 (vector P1 tets)."""
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels

    out = {}
    for k, nc in sizes:
        gen = torch.Generator(device=device).manual_seed(k)
        A64 = torch.randn((k, k, nc), generator=gen, dtype=torch.float64,
                          device=device)
        x64 = torch.randn((k, nc), generator=gen, dtype=torch.float64,
                          device=device)
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).replace("torch.", "")
            A, x = A64.to(dtype), x64.to(dtype)
            r = _compare("k5", f"k={k} {name} nc={nc}",
                         lambda: cuda_kernels.element_matvec(A, x),
                         lambda: cuda_kernels.element_matvec_reference(A, x),
                         k5_bytes(nc, A.element_size(), k), k5_flops(nc, k),
                         name, TOL[name], library=True)
            if name == "float64" and k == 4:
                out.update(r)
            del A, x
        del A64, x64
    return out


def _tables(device, dtype, tdim=3):
    """P1 simplex basis values, gradients and weights of the degree-2 rule."""
    import torch

    from fenicssolver_tpu_torch.ops import geometry

    tab = geometry.basis_tables(tdim, 1, 2)
    return (torch.as_tensor(a, dtype=dtype, device=device)
            for a in (tab.phi, tab.dphi, tab.qw))


def poisson_kernel(device, dtype, tdim=3):
    """The residual kernel of the dry run's ``poisson3d_p1`` case
    (``__graft_entry__.py:66-70``): P1 Poisson, f = 1, on simplices of
    dimension ``tdim``."""
    import torch

    from fenicssolver_tpu_torch.ops import geometry

    phi, dphi, qw = _tables(device, dtype, tdim)

    def kernel(ue, geom, aux):
        dphig = geometry.phys_grads(dphi, geom.Jinv)
        g = geometry.interp_grad(dphig, ue)
        r = torch.einsum("q,qg,qig->i", qw, g, dphig) * geom.detJ
        return r - torch.einsum("q,qi->i", qw, phi) * geom.detJ

    return kernel


def elasticity_kernel(device, dtype):
    """The residual kernel of the dry run's ``elasticity3d_p1`` case
    (``__graft_entry__.py:98-111``): small-strain elasticity, mu = 1,
    lambda = 1.5, body load (0, 0, -1); the trace as ``diagonal().sum()``."""
    import torch

    from fenicssolver_tpu_torch.ops import geometry

    phi, dphi, qw = _tables(device, dtype)
    d, ks = 3, phi.shape[1]
    mu, lmbda = 1.0, 1.5
    eye = torch.eye(d, dtype=dtype, device=device)
    f = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=device)

    def kernel(ue, geom, aux):
        U = ue.reshape(ks, d)
        dphig = geometry.phys_grads(dphi, geom.Jinv)
        gradU = torch.einsum("qkg,kv->qvg", dphig, U)
        eps = 0.5 * (gradU + gradU.transpose(1, 2))
        tr = torch.diagonal(eps, dim1=1, dim2=2).sum(-1)
        sig = 2 * mu * eps + lmbda * tr[:, None, None] * eye
        wdet = qw * geom.detJ
        r = torch.einsum("q,qvg,qkg->kv", wdet, sig, dphig)
        r = r - torch.einsum("q,v,qk->kv", wdet, f, phi)
        return r.reshape(-1)

    return kernel


def sharded_problem(core, kernel_fn, n, vector, device, dtype):
    """The dry run's case on ``UnitCubeMesh(n)``: the space, the kernel,
    the load ``b = -R(0)`` and the Dirichlet data (zero on the whole
    boundary, found from the vertex coordinates of the unit cube)."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.ops import assembly, geometry

    mesh = core.UnitCubeMesh(n, n, n)
    V = (core.VectorFunctionSpace if vector else core.FunctionSpace)(mesh, "CG", 1)
    kernel = kernel_fn(device, dtype)
    ctx = geometry.build_cell_context(V, 2, device=device, dtype=dtype)
    form = assembly.Form(space=V,
                         cell_terms=[assembly.CellTerm(kernel=kernel, ctx=ctx)])
    b = -assembly.assemble_residual(
        form, torch.zeros(V.ndof, dtype=dtype, device=device))
    on_shell = np.any((V.dof_coords == 0.0) | (V.dof_coords == 1.0), axis=1)
    dd = assembly.DirichletData(V.ndof)
    dd.add(np.nonzero(on_shell)[0], 0.0)
    dd.finalize(device=device, dtype=dtype)
    return V, kernel, form, b, dd


def _sharded_run(tag, V, kernel, b, dd, devices, tol):
    """Construct and solve with launch counts reset just before; print the
    setup and solve times, iterations, K5 launches and peak memory."""
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels
    from fenicssolver_tpu_torch.parallel import ShardedEllipticSolver

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    solver = ShardedEllipticSolver(V, kernel, devices=devices, dtype=b.dtype)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x, iters = solver.solve(b, dd.free_mask, dd.u_bc, tol=tol, maxiter=4000)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = cuda_kernels.LAUNCHES["element_matvec"]
    print(f"[sharded] {tag}: {V.ndof} dofs, {V.mesh.num_cells()} cells, "
          f"k = {V.cell_dofs.shape[1]}, {len(devices)} shard(s); setup "
          f"(partition, geometry, element matrices) {t1 - t0:.3f} s; solve "
          f"{t2 - t1:.3f} s, {iters} Jacobi-CG iterations, "
          f"{(t2 - t1) / max(iters, 1) * 1e3:.3f} ms/iteration; K5 launches "
          f"{launches}; peak device memory {_peak_gib():.2f} GiB")
    check(launches > 0, f"{tag}: K5 was not launched on the sharded path")
    check(bool(torch.isfinite(x).all()), f"{tag}: non-finite solution")
    del solver
    return x, iters, launches


def phase_sharded(device="cuda", n=N_MAIN, n_elas=N_ELAS, n_four=N_FOUR):
    """The cell-sharded matrix-free solve: (a) Poisson at n against
    ``run_stencil(n)``, (b) elasticity against the CSR solve, (c) four
    shards against one."""
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la import krylov
    from fenicssolver_tpu_torch.lattice_poisson import run_stencil
    from fenicssolver_tpu_torch.ops import assembly

    f64 = torch.float64
    dev = torch.device(device)

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    # (a) poisson3d_p1 at n, one shard, against the lattice solve
    t0 = time.perf_counter()
    V, kernel, form, b, dd = sharded_problem(core, poisson_kernel, n, False,
                                             dev, f64)
    del form
    print(f"[sharded] poisson3d_p1 n={n}: mesh, space, load and boundary "
          f"{time.perf_counter() - t0:.2f} s")
    x, iters, launches = _sharded_run(f"poisson3d_p1 n={n}", V, kernel, b, dd,
                                      [dev], 1e-10)
    del V, kernel, b, dd
    r = run_stencil(n, tol=1e-10, dtype=f64, device=dev)
    u_max = float(x.max())
    rel_max = abs(u_max - r["u_max"]) / r["u_max"]
    rel_field = rel_l2(x, r["u"])  # the mesh's dofs are the lattice's, C-order
    print(f"[sharded] vs run_stencil({n}, tol=1e-10) f64 ({r['iterations']} "
          f"GMG-CG iterations): u_max {u_max:.12f} vs {r['u_max']:.12f}, rel "
          f"{rel_max:.3e} (tol 1e-8); field rel-L2 {rel_field:.3e} (tol 1e-8)")
    check(rel_max <= 1e-8, f"sharded u_max rel {rel_max}")
    check(rel_field <= 1e-8, f"sharded field rel-L2 {rel_field}")
    del x, r

    # (b) elasticity3d_p1, one shard, against the assembled CSR Jacobi-CG
    V, kernel, form, b, dd = sharded_problem(core, elasticity_kernel, n_elas,
                                             True, dev, f64)
    x, iters_e, _ = _sharded_run(f"elasticity3d_p1 n={n_elas}", V, kernel, b,
                                 dd, [dev], 1e-10)
    form.finalize()
    A = assembly.assemble_jacobian(form, torch.zeros_like(b))
    op = assembly.constrained_operator(A.matvec, dd.free_mask)
    rhs = assembly.constrained_rhs(A.matvec, b, dd.free_mask, dd.u_bc)
    diag = dd.free_mask * A.diagonal() + (1 - dd.free_mask)
    x_ref, iters_ref, _ = krylov.cg(op, rhs,
                                    M=krylov.jacobi_preconditioner(diag),
                                    tol=1e-10, maxiter=4000)
    rel = rel_l2(x, x_ref)
    print(f"[sharded] elasticity3d_p1 vs CSR Jacobi-CG ({iters_ref} "
          f"iterations): rel-L2 {rel:.3e} (tol 1e-8), |u|_max "
          f"{float(x.abs().max()):.6e}")
    check(rel <= 1e-8, f"elasticity rel-L2 {rel}")
    del V, kernel, form, b, dd, A, x, x_ref

    # (c) poisson3d_p1 at n_four: four shards of one card against one
    V, kernel, _, b, dd = sharded_problem(core, poisson_kernel, n_four,
                                          False, dev, f64)
    x1, i1, _ = _sharded_run(f"poisson3d_p1 n={n_four}", V, kernel, b, dd,
                             [dev], 1e-10)
    x4, i4, _ = _sharded_run(f"poisson3d_p1 n={n_four}", V, kernel, b, dd,
                             [dev] * 4, 1e-10)
    rel = rel_l2(x4, x1)
    print(f"[sharded] 4 shards vs 1: rel-L2 {rel:.3e} (tol 1e-10), "
          f"iterations {i4} vs {i1}")
    check(rel <= 1e-10, f"4 shards vs 1 rel-L2 {rel}")
    check(abs(i4 - i1) <= 2, f"iterations {i4} vs {i1}")
    return {"launches": launches, "iterations": iters}


def phase_main_path(device="cuda", n=N_MAIN):
    """main(settings) on UnitCubeMesh(n) with GMG-CG: phase times,
    iterations, K2 launches, peak device memory, and the analytic check;
    then ``profile_vcycle`` on the solve's hierarchy."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.ops import cuda_kernels

    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = core.UnitCubeMesh(n, n, n)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    V = core.FunctionSpace(mesh, "CG", 1)
    t_space = time.perf_counter() - t0
    settings = heat_settings(core, V)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    solver = run_main(settings, device=device)
    t_main = time.perf_counter() - t0
    launches = cuda_kernels.LAUNCHES["stencil_apply_const"]
    tt = dict(solver.timers.totals)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_cuda else float("nan")
    T = solver.result.values
    z = V.dof_coords[:, 2]
    err = float(np.abs(T - (300.0 + 60.0 * z)).max() / 360.0)
    t_setup = t_main - sum(tt.values())
    relres = solver.last_relres
    relres = "n/a (direct solve)" if relres is None else f"{relres:.3e}"
    print(f"[main] n={n}: {V.ndof} dofs, {mesh.num_cells()} tets, {device}")
    print(f"[main] phases (s): mesh {t_mesh:.2f}, space {t_space:.2f}, "
          f"rest of main() (solver init: facet topology, boundary marking) "
          f"{t_setup:.2f}, "
          f"form {tt.get('form', 0):.2f}, assembly {tt.get('assembly', 0):.2f}, "
          f"gmg setup {tt.get('gmg_setup', 0):.2f}, "
          f"solve {tt.get('krylov', 0):.3f}; main() total {t_main:.2f}")
    print(f"[main] {solver.last_iterations} CG iterations, rel residual "
          f"{relres}, K2 launches {launches}, peak device "
          f"memory {peak:.2f} GiB, max|T - (300 + 60 z)|/360 = {err:.3e}")
    check(hasattr(solver, "_gmg_cache"), "the GMG branch did not run")
    check(isinstance(solver.last_iterations, int)
          and solver.last_iterations <= 60,
          f"iterations {solver.last_iterations} > 60")
    check(err <= 1e-6, f"max|T - (300 + 60 z)|/360 = {err}")
    if on_cuda:
        check(launches > 0, "K2 was not launched on the main path")
        profile_vcycle(solver._gmg_cache[1])
    return {"launches": launches, "iterations": solver.last_iterations, "V": V}


def _profiled(fn, reps):
    """(device-busy ms, of it the stencil kernels' ms, device events) per
    call of ``fn``, from ``torch.profiler`` over ``reps`` calls; None where
    the profiler saw no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    busy = sum(e.time_range.elapsed_us() for e in dev)
    stencil = sum(e.time_range.elapsed_us() for e in dev if "stencil" in e.name)
    return busy / 1e3 / reps, stencil / 1e3 / reps, len(dev) / reps


def profile_vcycle(G, cycles=20, calls=200):
    """The V-cycle of a solve's GMG hierarchy ``G`` (``la/gmg.GMGData``) on
    a seeded random residual: wall ms a cycle (synchronised over
    ``cycles``); device-busy ms a cycle and K2's part of it
    (``torch.profiler``, 10 cycles) and so the device's idle share; and
    for each level, K2's device time a launch (``time_ms``, warm: the
    V-cycle finds its operand in L2) and host time a call (``calls``
    enqueued back to back, no sync)."""
    import torch

    from fenicssolver_tpu_torch.la import gmg
    from fenicssolver_tpu_torch.ops import cuda_kernels

    free = G.levels[0].free3
    gen = torch.Generator(device=free.device).manual_seed(3)
    r = torch.randn(free.numel(), generator=gen, dtype=free.dtype,
                    device=free.device)
    for _ in range(3):
        gmg.vcycle(G, r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cycles):
        gmg.vcycle(G, r)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / cycles * 1e3
    prof = _profiled(lambda: gmg.vcycle(G, r), 10)
    if prof is None:
        dev = "device busy not measured (the profiler saw no device events)"
    else:
        busy, k2, events = prof
        dev = (f"device busy {busy:.4f} ms a cycle ({events:.0f} device "
               f"events), idle {100 * (1 - busy / wall):.1f}%; K2 {k2:.4f} ms "
               f"of it ({100 * k2 / busy:.1f}%)")
    print(f"[vcycle] {len(G.levels)} smoothed levels + {G.coarse_inv.shape[0]}"
          f"-dof dense coarse solve, {free.dtype}: wall {wall:.4f} ms a cycle "
          f"({cycles} cycles); {dev}")
    for li, lv in enumerate(G.levels):
        x = torch.randn(lv.free3.shape, generator=gen, dtype=free.dtype,
                        device=free.device)

        def apply():
            return cuda_kernels.stencil_apply_const(x, lv.coefs, lv.free3)

        dev_ms = time_ms(apply)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            apply()
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        print(f"[vcycle] level {li} {tuple(lv.free3.shape)}: K2 {dev_ms:.4f} ms "
              f"a launch on the device (warm), {host_us:.1f} us a call on the "
              f"host; {2 * G.nu} launches a cycle")


def phase_body_source(device="cuda", n=32):
    """A non-trivial solution: the CUDA solve against the port's CPU solve."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    res = {}
    for dev in (device, "cpu"):
        V = core.FunctionSpace(core.UnitCubeMesh(n, n, n), "CG", 1)
        s = ScalarTransportSolver(heat_settings(core, V, body_source=1000.0),
                                  device=dev)
        res[dev] = (s.solve().values.copy(), s.last_iterations)
    (Tg, ig), (Tc, ic) = res[device], res["cpu"]
    rel = float(np.linalg.norm(Tg - Tc) / np.linalg.norm(Tc))
    print(f"[body_source] n={n}: {device} {ig} iterations, cpu {ic} "
          f"iterations, rel-L2 {rel:.3e}, T max {Tg.max():.4f}")
    check(rel <= 1e-10, f"body-source rel-L2 {rel}")
    check(abs(ig - ic) <= 1, f"iterations {ig} vs {ic}")


def phase_cli(device="cuda"):
    """The bundled JSON case on the card."""
    import numpy as np

    from fenicssolver_tpu_torch.main import load_settings, main as run_main

    settings = load_settings(os.path.join(HERE, "data", "TestHeatTransfer.json"))
    solver = run_main(settings, device=device)
    z = solver.function_space.dof_coords[:, 2]
    T_exact = 350.0 - 2.5 * z
    err = float(np.linalg.norm(solver.result.values - T_exact)
                / np.linalg.norm(T_exact))
    print(f"[cli] data/TestHeatTransfer.json on {device}: rel-L2 vs "
          f"350 - 2.5 z = {err:.3e}")
    check(err <= 1e-8, f"CLI case rel-L2 {err}")


# -- the transient, advective, nonlinear and saving paths ---------------------

#: the sine mode of the transient check, on T = 300 + 60 z
SINE_MODE = "10*sin(pi*x[0])*sin(pi*x[1])*sin(pi*x[2])"
DT = 1e-3


def transient_settings(core, V, steps, saving=None):
    """The decaying sine mode on the unit cube: alpha = k/(rho c_p) = 1,
    T = 300 + 60 z on all six faces, T0 = that plus ``SINE_MODE``, ``steps``
    Crank-Nicolson steps of ``DT``, GMG-CG at ``RTOL``, cached transient
    form; ``saving``: the PVD path, saved every step."""
    wall = core.AutoSubDomain(lambda x, on_boundary: on_boundary)
    report = {"logging_level": 40}
    if saving:
        report.update(saving_freq=1, result_filename=saving)
    return {
        "solver_name": "ScalarTransportSolver",
        "scalar_name": "temperature", "function_space": V, "mesh": None,
        "boundary_conditions": {
            "walls": {"boundary": wall, "boundary_id": 1, "type": "Dirichlet",
                      "value": "300 + 60*x[2]"},
        },
        "initial_values": {"temperature": f"300 + 60*x[2] + {SINE_MODE}"},
        "material": {"density": 1.0, "specific_heat_capacity": 1.0,
                     "thermal_conductivity": 1.0},
        "solver_settings": {
            "transient_settings": {"transient": True, "starting_time": 0.0,
                                   "time_step": DT, "ending_time": steps * DT},
            "reference_values": {},
            "solver_parameters": {"relative_tolerance": RTOL,
                                  "maximum_iterations": 3000,
                                  "preconditioner": "gmg",
                                  "cache_transient_form": True},
        },
        "report_settings": report,
    }


class StepProbe:
    """Records, for each ``solve_current_step`` of the solver class while
    active: the phase times it added, its iterations, the K2 launches it
    made and (``keep``) a copy of the solution."""

    PHASES = ("form", "form_cache_refresh", "assembly", "gmg_setup", "krylov",
              "newton")

    def __init__(self, cls, keep=False):
        self.cls, self.keep, self.steps = cls, keep, []

    def __enter__(self):
        from fenicssolver_tpu_torch.ops import cuda_kernels

        inner = self.inner = self.cls.solve_current_step
        self.own = "solve_current_step" in vars(self.cls)
        probe = self

        def step(solver):
            before = dict(solver.timers.totals)
            k2 = cuda_kernels.LAUNCHES["stencil_apply_const"]
            inner(solver)
            probe.steps.append({
                "times": {k: solver.timers.totals.get(k, 0.0) - before.get(k, 0.0)
                          for k in probe.PHASES},
                "iterations": solver.last_iterations,
                "k2": cuda_kernels.LAUNCHES["stencil_apply_const"] - k2,
                "T": solver.w_current.values.copy() if probe.keep else None,
            })

        self.cls.solve_current_step = step
        return self

    def __exit__(self, *exc):
        if self.own:
            self.cls.solve_current_step = self.inner
        else:
            del self.cls.solve_current_step


def phase_transient(device="cuda", n=N_MAIN, steps=3, V=None):
    """This slice's main path: ``main(settings)`` on the transient heat case
    (``transient_settings``) on ``UnitCubeMesh(n)``'s P1 space ``V`` (the
    steady phase's, when given), f64, GMG-CG at ``RTOL`` every step.  One
    line a step (form build or cached-form refresh, assembly, GMG setup,
    Krylov, iterations, K2 launches); checks the CN decay of the sine mode,
    <= 60 iterations and K2 launches on every step; then ``profile_form``."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.ops import cuda_kernels
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    on_cuda = torch.device(device).type == "cuda"
    if V is None:
        V = core.FunctionSpace(core.UnitCubeMesh(n, n, n), "CG", 1)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with StepProbe(ScalarTransportSolver, keep=True) as probe:
        solver = run_main(transient_settings(core, V, steps), device=device)
    t_main = time.perf_counter() - t0
    launches = cuda_kernels.LAUNCHES["stencil_apply_const"]
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_cuda else float("nan")
    x = V.dof_coords
    base = 300.0 + 60.0 * x[:, 2]
    mode = 10.0 * np.prod(np.sin(np.pi * x), axis=1)
    g = (1 - 1.5 * np.pi**2 * DT) / (1 + 1.5 * np.pi**2 * DT)
    stepped = sum(sum(step["times"].values()) for step in probe.steps)
    print(f"[transient] n={n}: {V.ndof} dofs, {V.mesh.num_cells()} tets, "
          f"{device}, {len(probe.steps)} CN steps of {DT:g}; main() "
          f"{t_main:.2f} s, of it solver init {t_main - stepped:.2f} s; peak "
          f"device memory {peak:.2f} GiB; K2 launches {launches}")
    for k, st in enumerate(probe.steps):
        t = st["times"]
        form = (f"form build {t['form']:.2f}" if t["form"] else
                f"cached-form refresh {t['form_cache_refresh']:.3f}")
        err = float(np.abs(st["T"] - base - g ** (k + 1) * mode).max())
        print(f"[transient] step {k}: {form} s, assembly {t['assembly']:.2f} "
              f"s, gmg setup {t['gmg_setup']:.2f} s, krylov {t['krylov']:.3f} "
              f"s, {st['iterations']} CG iterations, K2 launches {st['k2']}, "
              f"max|T - (300 + 60 z) - 10 g^{k + 1} mode| = {err:.3e}")
        check(isinstance(st["iterations"], int) and st["iterations"] <= 60,
              f"step {k}: iterations {st['iterations']} > 60")
        check(err <= 1e-2, f"step {k}: decay error {err} > 1e-2")
        if on_cuda:
            check(st["k2"] > 0, f"step {k}: K2 was not launched")
    check(len(probe.steps) == steps, f"{len(probe.steps)} steps, not {steps}")
    check(hasattr(solver, "_gmg_cache"), "the GMG branch did not run")
    check(solver.timers.counts["form"] == min(steps, 2)
          and solver.timers.counts["form_cache_refresh"] == max(steps - 2, 0),
          "forms not built at steps 0 and 1 and refreshed after")
    profile_form(solver)
    return {"launches": launches, "iterations": [st["iterations"] for st in
                                                 probe.steps]}


def profile_form(solver, top=10):
    """One more ``generate_form`` of the solver's last step under cProfile:
    its wall time, the port's functions by cumulative time and all
    functions by own time (host work; device work it queues is synchronised
    at the end)."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    solver.generate_form(solver.current_step, None, None, solver.w_current,
                         solver.w_current)
    if torch.device(solver.device).type == "cuda":
        torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats

    def where(key):
        fn, line, name = key
        if fn.startswith(HERE):
            return f"{os.path.relpath(fn, HERE)}:{line}({name})"
        return f"{os.path.basename(fn)}:{line}({name})" if line else name

    ours = sorted(((v[3], where(k)) for k, v in stats.items()
                   if k[0].startswith(os.path.join(HERE, "fenicssolver_tpu_torch"))),
                  reverse=True)[:top]
    own = sorted(((v[2], where(k)) for k, v in stats.items()), reverse=True)[:top]
    print(f"[form] one form build under cProfile: {wall:.2f} s wall")
    print("[form] port functions by cumulative s: "
          + "; ".join(f"{w} {t:.2f}" for t, w in ours))
    print("[form] all functions by own s: "
          + "; ".join(f"{w} {t:.2f}" for t, w in own))


def scalar_settings(core, V, material, **extra):
    """A steady scalar case on the unit cube: T = 300 at z = 0 and 360 at
    z = 1, natural side walls, rtol 1e-10; ``extra`` settings added."""
    bottom = core.AutoSubDomain(lambda x: core.near(x[2], 0.0))
    top = core.AutoSubDomain(lambda x: core.near(x[2], 1.0))
    s = {
        "solver_name": "ScalarTransportSolver",
        "scalar_name": "temperature", "function_space": V, "mesh": None,
        "boundary_conditions": {
            "cold": {"boundary": bottom, "boundary_id": 1, "type": "Dirichlet",
                     "value": 300.0},
            "hot": {"boundary": top, "boundary_id": 2, "type": "Dirichlet",
                    "value": 360.0},
        },
        "material": {"density": 1000.0, "specific_heat_capacity": 4200.0,
                     **material},
        "solver_settings": {
            "transient_settings": {"transient": False},
            "reference_values": {"temperature": 300.0},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 5000},
        },
        "report_settings": {"logging_level": 40},
    }
    s.update(extra)
    return s


def _rel_l2(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_advection(device="cuda", n=48):
    """3-D SUPG advection-diffusion (the counterpart of
    ``test_convective_velocity_supg``): capacity 1, k 0.6, v = (0, 0, -0.6),
    ``"SPUG"``, Pe 1, against the exact exponential profile.  The reference
    sends this non-symmetric system through Jacobi-BiCGStab (GMRES after a
    breakdown), so no TPU kernel runs, and n is kept small."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    V = core.FunctionSpace(core.UnitCubeMesh(n, n, n), "CG", 1)
    s = scalar_settings(core, V, {"capacity": 1.0, "conductivity": 0.6},
                        convective_velocity=(0.0, 0.0, -0.6),
                        advection_settings={"stabilization_method": "SPUG",
                                            "Pe": 1.0})
    t0 = time.perf_counter()
    solver = run_main(s, device=device)
    wall = time.perf_counter() - t0
    z = V.dof_coords[:, 2]
    lam = -0.6 / 0.6
    exact = 300.0 + 60.0 / (np.exp(lam) - 1.0) * (np.exp(lam * z) - 1.0)
    err = _rel_l2(solver.result.values, exact)
    print(f"[advection] n={n}: {V.ndof} dofs on {device}, finished by "
          f"{solver.last_krylov} in {solver.last_iterations} iterations (rel "
          f"residual {solver.last_relres:.3e}), main() {wall:.2f} s; rel-L2 vs "
          f"the exact profile {err:.3e} (tol 1e-3)")
    check(solver.last_krylov in ("BiCGStab", "GMRES"),
          f"the advective system was solved by {solver.last_krylov}")
    check(err <= 1e-3, f"advection rel-L2 {err}")


def _kT(T):
    return 0.6 * (1 + 0.001 * (T - 300.0))


def radiation_case(core, V):
    """k 0.6, radiation to 280 K (emissivity 0.9) on every exterior facet,
    and a point load of 50 W at the cube's centre."""
    return scalar_settings(
        core, V, {"conductivity": 0.6, "emissivity": 0.9},
        radiation_settings={"ambient_temperature": 280.0, "emissivity": 0.9},
        point_source=[((0.5, 0.5, 0.5), 50.0)])


def phase_nonlinear(device="cuda", n=48, n_cpu=12):
    """Newton: k(T) = 0.6 (1 + 0.001 (T - 300)) against the closed form of
    ``test_nonlinear_conductivity_newton``; then radiation with a point
    source at the centre, whose card solve at ``n_cpu`` matches the CPU's.
    The reference solves each Newton update by Jacobi-CG (no TPU kernel),
    so n is kept small."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    V = core.FunctionSpace(core.UnitCubeMesh(n, n, n), "CG", 1)
    t0 = time.perf_counter()
    solver = run_main(scalar_settings(core, V, {"conductivity": _kT}),
                      device=device)
    wall = time.perf_counter() - t0
    a, dT = 0.001, 60.0
    u = (dT + a / 2 * dT**2) * V.dof_coords[:, 2]
    err = _rel_l2(solver.result.values, 300 + (-1 + np.sqrt(1 + 2 * a * u)) / a)
    print(f"[nonlinear] k(T) n={n}: {V.ndof} dofs on {device}, "
          f"{solver.last_iterations} Newton iterations, newton "
          f"{solver.timers.totals['newton']:.2f} s, main() {wall:.2f} s; rel-L2 "
          f"vs the closed form {err:.3e} (tol 2e-5)")
    check(err <= 2e-5, f"k(T) rel-L2 {err}")
    t0 = time.perf_counter()
    solver = run_main(radiation_case(core, V), device=device)
    wall = time.perf_counter() - t0
    T = solver.result.values
    centre = float(solver.result((0.5, 0.5, 0.5)))
    print(f"[nonlinear] radiation + point source n={n}: {solver.last_iterations} "
          f"Newton iterations, main() {wall:.2f} s; T mean {T.mean():.4f}, "
          f"T at the centre {centre:.4f}, range [{T.min():.4f}, {T.max():.4f}]")
    check(np.isfinite(T).all() and T.mean() < 330.0,
          f"radiation: T mean {T.mean()} not below the conduction mean 330")
    res = {}
    for dev in (device, "cpu"):
        Vs = core.FunctionSpace(core.UnitCubeMesh(n_cpu, n_cpu, n_cpu), "CG", 1)
        sol = run_main(radiation_case(core, Vs), device=dev)
        res[dev] = (sol.result.values.copy(), sol.last_iterations)
    rel = _rel_l2(res[device][0], res["cpu"][0])
    print(f"[nonlinear] radiation + point source n={n_cpu}: {device} vs cpu "
          f"rel-L2 {rel:.3e} (tol 1e-8), Newton iterations "
          f"{res[device][1]} vs {res['cpu'][1]}")
    check(rel <= 1e-8, f"radiation {device} vs cpu rel-L2 {rel}")
    check(res[device][1] == res["cpu"][1], "Newton iterations differ")


def phase_save(device="cuda", n=16):
    """One transient step with ``saving_freq: 1`` into a temporary
    directory through ``main``: the PVD and its VTU parse, and the VTU's
    point data equals T to the writer's 12 significant digits."""
    import tempfile
    import xml.etree.ElementTree as ET

    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    with tempfile.TemporaryDirectory() as tmp:
        pvd = os.path.join(tmp, "result.pvd")
        V = core.FunctionSpace(core.UnitCubeMesh(n, n, n), "CG", 1)
        solver = run_main(transient_settings(core, V, 1, saving=pvd),
                          device=device)
        sets = [d.attrib for d in ET.parse(pvd).getroot().iter("DataSet")]
        check(len(sets) == 1, f"{len(sets)} data sets in the PVD, not 1")
        vtu = ET.parse(os.path.join(tmp, sets[0]["file"])).getroot()
        piece = next(vtu.iter("Piece")).attrib
        arr = next(a for a in vtu.iter("DataArray")
                   if a.attrib.get("Name") == solver.result.name())
        vals = np.array(arr.text.split(), dtype=np.float64)
    T = solver.result.values
    err = float(np.abs(vals - T).max() / np.abs(T).max())
    print(f"[save] n={n}: {pvd.rsplit(os.sep, 1)[-1]} with 1 data set at t = "
          f"{sets[0]['timestep']}, {sets[0]['file']}: {piece['NumberOfPoints']} "
          f"points, {piece['NumberOfCells']} cells; point data vs T max rel "
          f"{err:.1e} (tol 1e-11)")
    check(int(piece["NumberOfPoints"]) == V.ndof, "VTU point count")
    check(err <= 1e-11, f"saved point data rel err {err}")


def phase_transient_cli():
    """A transient copy of ``data/TestHeatTransfer.json`` (the file is not
    edited), P1 and P2, through ``python -m fenicssolver_tpu_torch`` with
    ``FST_DEVICE`` unset: each runs its three steps on the card."""
    import tempfile

    from fenicssolver_tpu_torch.main import load_settings

    env = {k: v for k, v in os.environ.items() if k != "FST_DEVICE"}
    env["PYTHONPATH"] = HERE
    for degree in (1, 2):
        settings = load_settings(os.path.join(HERE, "data", "TestHeatTransfer.json"))
        settings["fe_degree"] = degree
        settings["solver_settings"]["transient_settings"]["transient"] = True
        with tempfile.TemporaryDirectory() as tmp:
            case = os.path.join(tmp, "case.json")
            with open(case, "w") as f:
                json.dump(settings, f)  # the mesh path is absolute here
            proc = subprocess.run(
                [sys.executable, "-m", "fenicssolver_tpu_torch", case],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        print(f"[transient-cli] P{degree}, FST_DEVICE unset: rc {proc.returncode}; "
              f"{line}")
        check(proc.returncode == 0, f"P{degree} transient CLI: {proc.stderr[-2000:]}")
        check(" on cuda" in line and "3 time steps" in line,
              f"P{degree} transient CLI did not run 3 steps on the card")


def phase_default_device(n=16):
    """With ``FST_DEVICE`` unset and no ``device=``, the lattice CLI and
    ``run_stencil`` run on the card, through K1."""
    import contextlib
    import io

    import torch

    from fenicssolver_tpu_torch import lattice_poisson
    from fenicssolver_tpu_torch.ops import cuda_kernels

    saved = os.environ.pop("FST_DEVICE", None)
    try:
        cuda_kernels.reset_launch_counts()
        r = lattice_poisson.run_stencil(n)
        launches = cuda_kernels.LAUNCHES["stencil_apply_var"]
        check(r["u"].device == torch.device("cuda", 0),
              f"run_stencil({n}) ran on {r['u'].device}, not cuda:0")
        check(launches > 0, f"run_stencil({n}) did not launch K1")
        cuda_kernels.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = lattice_poisson.main(["--n", str(n)])
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        cli_launches = cuda_kernels.LAUNCHES["stencil_apply_var"]
        check(rc == 0 and rec["device"].startswith("cuda"),
              f"lattice CLI ran on {rec['device']}")
        check(cli_launches > 0, "the lattice CLI did not launch K1")
    finally:
        if saved is not None:
            os.environ["FST_DEVICE"] = saved
    print(f"[default-device] FST_DEVICE unset: run_stencil({n}) on "
          f"{r['u'].device}, {launches} K1 launches; lattice CLI --n {n} on "
          f"{rec['device']}, {cli_launches} K1 launches, {rec['iterations']} "
          f"iterations")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import fenicssolver_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import fenicssolver_tpu_torch ({e}); run it "
              "from the root of a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device()
    phase_build()
    k2 = phase_k2()
    k1 = phase_k1()
    k34 = phase_k3_k4()
    phase_default_device()
    steady = phase_main_path()
    transient = phase_transient(V=steady.pop("V"))
    phase_advection()
    phase_nonlinear()
    phase_save()
    phase_transient_cli()
    phase_body_source()
    phase_cli()
    lat = phase_lattice()
    csr = phase_csr()
    k5 = phase_k5()
    shard = phase_sharded()
    measured = {
        "stencil_apply_var": (k1, lat["launches"]["stencil_apply_var"]),
        "stencil_apply_const": (k2, transient["launches"]),
        "p1_stiffness_sym": (k34["p1_stiffness_sym"],
                             lat["launches"]["p1_stiffness_sym"]),
        "p1_stiffness": (k34["p1_stiffness"], csr["launches"]["p1_stiffness"]),
        "element_matvec": (k5, shard["launches"]),
    }
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches,
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "library_case": m["library_case"],
        "library_kernel_ms": m["library_kernel_ms"],
    } for name, (m, launches) in measured.items()]}
    print(f"[done] all phases passed on {card}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
