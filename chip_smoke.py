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
3. K2 (``stencil_apply_const``) against its plain PyTorch version at
   129^3 in f64 and f32, with two Dirichlet masks, timed with CUDA events;
4. K1 (``stencil_apply_var``) likewise at 129^3 with random tap fields,
   without a mask and with two masks;
5. K3 (``p1_stiffness_sym``) and K4 (``p1_stiffness``) likewise at
   6 * 128^3 = 12,582,912 cells with random well-conditioned Jacobians,
   K4 also with the 2-D reference gradients (k = 3);
6. main path: ``main(settings)`` on ``UnitCubeMesh(128)`` (2,146,689 dofs),
   f64, GMG-preconditioned CG at rtol 1e-10, with phase times, iterations,
   the K2 launch count and the peak device memory;
7. a body-source case at n=32 whose CUDA solve must match the CPU solve;
8. the bundled JSON case ``data/TestHeatTransfer.json`` on the card;
9. lattice path: ``lattice_poisson.run_stencil(128)`` (the port of
   ``bench.py``'s structured-lattice Poisson solve, 2,146,689 dofs, K3
   assembly, K1 operator, GMG-CG to 1e-6) in f32 and f64, held to the
   same-size CPU mirror's u_max; the three assembly modes' fields agree;
10. CSR path: ``lattice_poisson.run_csr(96)`` (K4 assembly into CSR)
    against ``run_stencil(96)``, in f64: K4's f32 element matrices lose the
    exact zero row sums that K3's packing keeps, which moves the f32
    solution by ~cond(A) * eps (1.5e-4 relative at n = 64 on the CPU).

Kernel times in the kernels' record are those of the dtype and mask of
the path that launches the kernel: K2 f64 with free sides (the heat path),
K1 (all-Dirichlet mask) and K3 f32 (the lattice path, in the bench's
dtype), K4 f64 (the CSR path).

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
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
KERNELS = {  # name: (source, TPU kernel it replaces)
    "stencil_apply_var": ("fenicssolver_tpu_torch/csrc/stencil.cu",
                          "fenicssolver_tpu/ops/pallas_kernels.py:308"),
    "stencil_apply_const": ("fenicssolver_tpu_torch/csrc/stencil.cu",
                            "fenicssolver_tpu/ops/pallas_kernels.py:363"),
    "p1_stiffness_sym": ("fenicssolver_tpu_torch/csrc/p1_stiffness.cu",
                         "fenicssolver_tpu/ops/pallas_kernels.py:144"),
    "p1_stiffness": ("fenicssolver_tpu_torch/csrc/p1_stiffness.cu",
                     "fenicssolver_tpu/ops/pallas_kernels.py:74"),
}
#: u_max of the same problem (n = 128, tol 1e-6) from the same-algorithm
#: f64 CPU mirror of the JAX package's bench (``bench.py:155-156``)
U_MAX_128 = 0.05620760176173512
N_CSR = 96  # the JAX bench's size for its assembled-matrix format


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


def time_ms(fn, reps=25, warmup=3):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def phase_build():
    from fenicssolver_tpu_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cuda_kernels.SOURCES)) as ex:
        paths = list(ex.map(cuda_kernels.build, cuda_kernels.SOURCES))
    print(f"[build] {len(paths)} sources in {time.perf_counter() - t0:.2f} s")
    for name, path in zip(cuda_kernels.SOURCES, paths):
        info = cuda_kernels.BUILD_INFO[name]
        print(f"[build] {os.path.relpath(path, HERE)} (nvcc {info['seconds']:.2f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")
    from fenicssolver_tpu_torch import native

    print("[build] host helpers native/fst_native.cpp: "
          + ("built with g++" if native.available() else "numpy fallbacks"))


def phase_k2(device="cuda"):
    """K2 against its plain version at the main path's finest shape."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.la import gmg
    from fenicssolver_tpu_torch.ops import cuda_kernels

    shape = (N_MAIN + 1,) * 3
    coefs = gmg.p1_box_stencil(1.0 / N_MAIN, 1.0 / N_MAIN, 1.0 / N_MAIN)
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal(shape)
    sides = np.ones(shape)
    sides[:, :, 0] = sides[:, :, -1] = 0.0  # top/bottom Dirichlet, free sides
    closed = np.zeros(shape)
    closed[1:-1, 1:-1, 1:-1] = 1.0  # all-Dirichlet
    out = {"max_abs_err": 0.0}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        x = torch.as_tensor(x_np, dtype=dtype, device=device)
        for mname, m_np in (("free-sides", sides), ("all-dirichlet", closed)):
            f = torch.as_tensor(m_np, dtype=dtype, device=device)
            y_k = cuda_kernels.stencil_apply_const(x, coefs, f)
            y_p = cuda_kernels.stencil_apply_const_reference(x, coefs, f)
            torch.cuda.synchronize()
            abs_err = float((y_k - y_p).abs().max())
            rel_err = abs_err / float(y_p.abs().max())
            ms = time_ms(lambda: cuda_kernels.stencil_apply_const(x, coefs, f))
            plain_ms = time_ms(
                lambda: cuda_kernels.stencil_apply_const_reference(x, coefs, f)
            )
            gbs = 3 * x.numel() * x.element_size() / (ms * 1e-3) / 1e9
            print(f"[k2] {name} {mname} {shape}: max abs err {abs_err:.3e}, "
                  f"rel {rel_err:.3e} (tol {TOL[name]:g}); kernel "
                  f"{ms:.4f} ms ({gbs:.0f} GB/s modelled), plain {plain_ms:.4f} ms")
            check(rel_err <= TOL[name], f"K2 {name} {mname} rel err {rel_err}")
            if name == "float64":
                out["max_abs_err"] = max(out["max_abs_err"], abs_err)
                if mname == "free-sides":
                    out["ms"], out["plain_ms"] = ms, plain_ms
    return out


def _compare(tag, what, kernel, plain, nbytes, tol):
    """Kernel against plain version on the same inputs: errors, check,
    CUDA-event times; returns (abs_err, ms, plain_ms)."""
    import torch

    y_k, y_p = kernel(), plain()
    torch.cuda.synchronize()
    abs_err = float((y_k - y_p).abs().max())
    rel_err = abs_err / float(y_p.abs().max())
    del y_k, y_p
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    print(f"[{tag}] {what}: max abs err {abs_err:.3e}, rel {rel_err:.3e} "
          f"(tol {tol:g}); kernel {ms:.4f} ms "
          f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s modelled), plain "
          f"{plain_ms:.4f} ms")
    check(rel_err <= tol, f"{tag} {what} rel err {rel_err}")
    return abs_err, ms, plain_ms


def phase_k1(device="cuda", n=N_MAIN):
    """K1 against its plain version at the lattice path's shape."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels

    shape = (n + 1,) * 3
    rng = np.random.default_rng(1)
    x_np = rng.standard_normal(shape)
    coef_np = rng.standard_normal((15,) + shape)
    sides = np.ones(shape)
    sides[:, :, 0] = sides[:, :, -1] = 0.0
    closed = np.zeros(shape)
    closed[1:-1, 1:-1, 1:-1] = 1.0
    out = {"max_abs_err": 0.0}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        x = torch.as_tensor(x_np, dtype=dtype, device=device)
        coef = torch.as_tensor(coef_np, dtype=dtype, device=device)
        for mname, m_np in (("no mask", None), ("free-sides", sides),
                            ("all-dirichlet", closed)):
            f = None if m_np is None else torch.as_tensor(m_np, dtype=dtype,
                                                          device=device)
            arrays = 17 if f is None else 18
            err, ms, plain_ms = _compare(
                "k1", f"{name} {mname} {shape}",
                lambda: cuda_kernels.stencil_apply_var(x, coef, f),
                lambda: cuda_kernels.stencil_apply_var_reference(x, coef, f),
                arrays * x.numel() * x.element_size(), TOL[name],
            )
            if name == "float32":
                out["max_abs_err"] = max(out["max_abs_err"], err)
                if mname == "all-dirichlet":
                    out["ms"], out["plain_ms"] = ms, plain_ms
        del x, coef, f
    return out


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
    out = {k: {"max_abs_err": 0.0} for k in ("p1_stiffness_sym", "p1_stiffness")}
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
                      (dim * dim + 1 + k * k) * nc * item)]
            if dim == 3:
                cases.insert(0, (
                    "p1_stiffness_sym", "K3",
                    lambda: cuda_kernels.p1_stiffness_sym(JinvT, detJ),
                    lambda: cuda_kernels.p1_stiffness_sym_reference(JinvT, detJ),
                    20 * nc * item))
            for kname, what, kern, plain, nbytes in cases:
                err, ms, plain_ms = _compare(
                    "k3" if kname == "p1_stiffness_sym" else "k4",
                    f"{what} {name} nc={nc}", kern, plain, nbytes, TOL[name])
                # the dtype of the path that launches it (module docstring)
                path_dtype = "float32" if kname == "p1_stiffness_sym" else "float64"
                if name == path_dtype and dim == 3:
                    out[kname].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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


def phase_main_path(device="cuda", n=N_MAIN):
    """main(settings) on UnitCubeMesh(n) with GMG-CG: phase times,
    iterations, K2 launches, peak device memory, and the analytic check."""
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
    return {"launches": launches, "iterations": solver.last_iterations}


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
    mainp = phase_main_path()
    phase_body_source()
    phase_cli()
    lat = phase_lattice()
    csr = phase_csr()
    measured = {
        "stencil_apply_var": (k1, lat["launches"]["stencil_apply_var"]),
        "stencil_apply_const": (k2, mainp["launches"]),
        "p1_stiffness_sym": (k34["p1_stiffness_sym"],
                             lat["launches"]["p1_stiffness_sym"]),
        "p1_stiffness": (k34["p1_stiffness"], csr["launches"]["p1_stiffness"]),
    }
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches,
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"],
    } for name, (m, launches) in measured.items()]}
    print(f"[done] all phases passed on {card}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
