#!/usr/bin/env python3
"""GPU smoke run of fenicssolver_tpu_torch: the quickest proof that the
port builds and runs its main path on an NVIDIA card.

Run from the repository root on a machine with one CUDA device (H100,
sm_90a) and ``nvcc``:

    python3 chip_smoke.py

Phases (each prints its findings on its own line; any failure exits
non-zero and no result line is printed):

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build: the CUDA kernel from ``fenicssolver_tpu_torch/csrc/`` for sm_90a;
3. K2 (``stencil_apply_const``) against its plain PyTorch version at
   129^3 in f64 and f32, with two Dirichlet masks, timed with CUDA events;
4. main path: ``main(settings)`` on ``UnitCubeMesh(128)`` (2,146,689 dofs),
   f64, GMG-preconditioned CG at rtol 1e-10, with phase times, iterations,
   the K2 launch count and the peak device memory;
5. a body-source case at n=32 whose CUDA solve must match the CPU solve;
6. the bundled JSON case ``data/TestHeatTransfer.json`` on the card.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_MAIN = 128
RTOL = 1e-10
K2_SOURCE = "fenicssolver_tpu_torch/csrc/stencil.cu"
K2_REPLACES = "fenicssolver_tpu/ops/pallas_kernels.py:363"
K2_TOL = {"float64": 1e-12, "float32": 1e-5}


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
    path = cuda_kernels.build("stencil")
    info = cuda_kernels.BUILD_INFO["stencil"]
    print(f"[build] {os.path.relpath(path, HERE)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
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
                  f"rel {rel_err:.3e} (tol {K2_TOL[name]:g}); kernel "
                  f"{ms:.4f} ms ({gbs:.0f} GB/s modelled), plain {plain_ms:.4f} ms")
            check(rel_err <= K2_TOL[name], f"K2 {name} {mname} rel err {rel_err}")
            if name == "float64":
                out["max_abs_err"] = max(out["max_abs_err"], abs_err)
                if mname == "free-sides":
                    out["ms"], out["plain_ms"] = ms, plain_ms
    return out


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
    mainp = phase_main_path()
    phase_body_source()
    phase_cli()
    kernels = {"kernels": [{
        "name": "stencil_apply_const", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": mainp["launches"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
    }]}
    print(f"[done] all phases passed on {card}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
