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
   PyTorch call computes it); K1's bf16-storage instance
   (``stencil_apply_var_bf16``) over the same shapes and masks, every
   output within one bf16 ulp of its plain version, timed at 129^3 beside
   the f32 K1 on the same values;
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
   step, one form build (its CSR pattern sorted on the card) and the cached
   form refreshed, with A kept, on the later steps; one line a step (form
   build or refresh, assembly with A kept or rebuilt, GMG setup, Krylov,
   iterations, K2 launches); checks the CN decay to 1e-2, <= 60 iterations
   and K2 on every step; then one more form build under cProfile, and the
   form's pattern from the card, and at n = 64 the card's pattern beside,
   and identical to, the host's;
6b'. determinism: two assemblies of that form are bit-equal, beside the
   assembly time with ``index_add_``'s atomics and the times of one chunk's
   scatter by ``index_add_``, by ``index_put_(accumulate=True)``, by
   ``segment_reduce`` and by the presorted ``OrderedScatter``; repeated CSR
   products are bit-equal;
6b''. fast path: ``fast_paths.compile_transient_heat`` on the same settings,
   three steps (``T_final`` against the time loop's third step to 1e-7, the
   CN decay) and ten (seconds a step), Jacobi-PCG iterations a step;
6c. SUPG advection at n = 48 (BiCGStab, or GMRES after a breakdown) against
   the exact exponential profile to 1e-3; its iteration count is the same
   in every call of this script (the sums of assembly have a fixed order);
6d. Newton at n = 48: k(T) against its closed form to 2e-5; radiation with
   a point source (and the same at n = 12 on the card and the CPU, 1e-8);
6e. saving: one transient step at n = 16 with ``saving_freq: 1``; the PVD
   and VTU parse and hold T; then a transient copy of the JSON case, P1 and
   P2, a DG copy and a copy restarted from a ``.npz`` checkpoint, through
   ``python -m fenicssolver_tpu_torch`` with ``FST_DEVICE`` unset, run on
   the card;
6f. DG: ``ScalarTransportDGSolver`` on ``UnitCubeMesh(32)`` (196,608 tets,
   786,432 DG1 dofs): SIPG diffusion against the linear profile (1e-6) by
   Jacobi-CG, upwind advection against the exponential profile (1e-3) by
   BiCGStab; periodic: tests/test_periodic.py's case on a 256 x 256 mesh
   (the x = 1 edge tied to x = 0 to 1e-8); restart: a transient state saved
   at n = 16 (``save_state``, ``save_function``), loaded into a fresh
   solver on the same mesh and, interpolated, as the initial field of a
   solver on another;
7. a body-source case at n=32 whose CUDA solve must match the CPU solve;
8. the bundled JSON case ``data/TestHeatTransfer.json`` on the card;
8b. elasticity: the cantilever of
   tests/test_linear_elasticity.py on ``BoxMesh(320, 32, 32)``, vector P1
   (1,048,707 dofs, 1,966,080 tets), f64, steel, clamped at x = 0, a tip
   force at x = 10, rtol 1e-8, through ``main(settings)`` on the default
   device: the recorded preconditioner must be ``amg`` (smoothed
   aggregation with the rigid-body near-nullspace, its set-up's products
   on the card; the seconds of each set-up step by level),
   CG within ``MAX_CG_CANTILEVER`` iterations, the tip deflection within 8%
   of Euler-Bernoulli, ``von_Mises`` finite; prints the AMG set-up's
   seconds by level with rows and nnz, form and assembly seconds, the
   chunk for k = 12, the peak memory, the iterations, the wall ms a V-cycle
   and a CG iteration and the device's idle share over ten iterations; then
   thermal free expansion on ``UnitSquareMesh(256)`` (sliding supports,
   +50 K, AMG-CG) against the exact field to 1e-9; then the vector P2
   cantilever (k = 30) at 20 x 3 x 3 on the card against the port's CPU
   solve (1e-8, equal iterations).  F5: the cantilever's AMG V-cycle
   applied twice is bit-equal and a second CG solve takes main()'s count to
   the same bits; ``csr_spmv`` (its launches counted in main()) against
   cuSPARSE on the hierarchy's level 0 (A, a block of 6 columns, R, P) and
   timed on A; the same CG to 1e-10 for 8h.  Before it, F5's set-up part
   ([amg-setup-repeat]): the cantilever's set-up at 160 x 16 x 16 (139,587
   dofs) in this process and in another at the same time gives the same
   bits in every step (strength graph, aggregates, tentative prolongator,
   D^-1 A, power estimates, the products) and every level's arrays, and
   the two AMG-CG solves the same count and bits;
8c. modal: ``solve_modal(6)`` of a clamped P1 beam at 41,904 dofs; the
   recorded backend must be ``lobpcg`` (LOBPCG with the AMG V-cycle on the
   card), the frequencies within 1e-4 of scipy's shift-invert ``eigsh`` on
   the same K and M;
8d. the body-source heat case with ``preconditioner: "amg"`` against
   ``"gmg"`` (1e-8); the standing wave of tests/test_wave.py, P2, at the
   test's size to the test's bounds and at 255 x 255 (261,121 dofs; energy
   conserved to 1e-9 from the first step to the last); the magnetostatic
   slab of tests/test_maxwell.py at 120 x 120, P2 (1e-8); an elasticity
   JSON case on ``data/mesh.xml`` through ``python -m
   fenicssolver_tpu_torch``;
8e. nonlinear solids, through ``main(settings)`` on the default device:
   the hyperelastic twist of examples/test_nonlinear_elasticity.py at
   ``UnitCubeMesh(24, 16, 16)`` (21,675 dofs, Newton with Jacobi-GMRES(80)
   updates, one line a Newton step, the Hessian's memory a cell against its
   chunk; at 4^3 the card against the CPU to 1e-9); the contact cases of
   examples/test_contact_mechanics.py (a plane at 64 x 64 for two penalties:
   force balance, the forces within 2%, the penetration ratio; the ball at
   24 x 24); the J2 bar of tests/test_plasticity.py at ``UnitCubeMesh(24)``
   (46,875 dofs, every quadrature point's sigma_xx within 1e-6 of the
   bilinear law at every load step, alpha frozen while unloading); the
   large-deformation beam at 128 x 16 for nu = 0.3 and 0.5 (and at n = 16
   the card against the CPU to 1e-9); the elastodynamics fast path against
   the time loop at 19,683 dofs (1e-6), its set-up and seconds a step at
   139,587 dofs; the adjoint: the inverse conductivity problem of
   examples/test_adjoint_inverse.py by ``torch.optim.Adam`` with the
   example's assertions, and at 66,049 dofs a gradient against central
   differences (1e-6) that two calls give bit-equal;
8e'. the elbow of examples/test_cfd_solver.py through ``main(settings)``
   on the default device: the 2-D elbow at res 8 and the 3-D elbow of
   ``setup_case_3d`` at res 5 (11,829 Taylor-Hood dofs), each finite with
   |u| < 3 and the outflow within 2% of the inflow (``assemble_functional``
   over boundaries 2 and 3, two calls bit-equal), with its dofs, seconds,
   Newton steps and their routes; the coupled temperature at res 7.
   ``python3 chip_smoke.py --only elbow-3d`` runs the build and the 3-D
   elbow at res 12 (143,128 dofs, the iterative saddle-point route) alone;
8f. the last three solvers, through ``main(settings)`` on the default
   device: ``NSDGSolver`` on the DG2/DG1 channel of
   examples/test_dg_flow.py at 64 x 64 (122,880 dofs) by ``fieldsplit``
   with the DG p-multigrid present (``check_dg_fieldsplit``), exact to
   1e-8, its net boundary flux (``assemble_functional`` over every
   exterior facet, two calls bit-equal) below 1e-8 of the inflow, two
   solves of one system bit-equal, the 3-D Couette duct at 6^3
   and 8^3 (104,448 dofs) with its peak device memory by part (each
   Jacobian term, the residual, ``_build_pmg``, FGMRES), the transient
   start-up against the CPU (1e-9);
   ``CompressibleNSSolver`` on the acoustic pulse of
   examples/test_compressible_flow.py at 1024^2 (1,050,625 nodes; mass and
   energy to 1e-12, the front within 10% of c t), Sod's tube at n = 400,
   the closed box at 12^2 against the CPU (1e-12) and twice on the card
   (bit-equal); ``FSISolver`` on the pressure-loaded cantilever of
   tests/test_fsi.py 8x as fine (fluid 23,603 dofs by fieldsplit), one
   line a step, the tip within 15% of Euler-Bernoulli, and at the test's
   size the card against the CPU after each step (1e-8);
8g. the distributed layer on ``SHARDS`` = 8 shards of ``cuda:0``, f64, each
   against the serial solve of the same system: with one shard a heat and
   an NS case warn and equal the run without the flag bit for bit; halo
   Jacobi-PCG (P1 Poisson at ``UnitCubeMesh(64)``, 274,625 dofs; P1
   elasticity at 32), element-sharded assembly with an HTC facet term at
   48, halo BiCGStab on an advection stencil, two solves bit-equal; the
   sharded AMG-CG of the perturbed-tet Poisson at n = 64 (iterations within
   2 of serial), the 12,027-dof NS channel by the sharded fieldsplit (outer
   within 15%), the distributed Newton of the twist; the sharded acoustic
   pulse at 256^2 (1e-12); the FSI cantilever x4 (tip 1e-8); F5: the
   serial and sharded AMG hierarchies applied twice bit-equal, a second
   solve with each the same count, a second sharded set-up bit-equal on
   every level with the same count;
8h. the sharded lattice GMG (``parallel/lattice.py``) on the same 8 shards,
   f64, rtol 1e-10, right after the fast path: the dry run's lattice
   Poisson at n = 128 (slabs), 64 (two axes) and 96 (2 x 4 pencils), each
   against ``run_stencil(n, tol=1e-10)`` (1e-8, iterations within 2, K1 and
   K2 launched, two solves bit-equal), then the steady heat case through
   ``main()`` with ``distributed: true`` (``last_preconditioner`` must be
   ``lattice_gmg``, 1e-8 against the serial solve); and right after 8b the
   vector route: the cantilever through ``main()`` with ``distributed:
   true`` (``lattice_gmg_vector``, truncated taps) against 8b's AMG-CG to
   1e-10 (tip and rel-L2 within 1e-6), ``run_elasticity(80)`` in f32 (the
   bench's elasticity path, 1,594,323 dofs) and ``run_elasticity(16)`` on
   the card against the CPU (1e-10);
9. lattice path: ``lattice_poisson.run_stencil(128)`` (the port of
   ``bench.py``'s structured-lattice Poisson solve, 2,146,689 dofs, K3
   assembly, K1 operator, GMG-CG to 1e-6) in f32 and f64, held to the
   same-size CPU mirror's u_max; the three assembly modes' fields agree;
9b. ``bench.py``'s last two paths: ``run_stencil(128, bf16=True)`` (the
    bf16 refinement solve: bf16 tap fields and PCG carries, K1's bf16
    instance, the f32 V-cycle and an f32 refinement on the true residual)
    against ``run_stencil(128)`` in f32 (u_max within 1e-3, the bench's
    rule; passes, residual, solve seconds and their ratio; K1-bf16 on the
    solver's own fields within one bf16 ulp); ``run_unstructured(100)``
    (P1 Poisson on the perturbed tets, 1,030,301 dofs, SA-AMG PCG in f32,
    every product ``csr_spmv``) to res 1e-6: set-up by step, levels,
    seconds, launches, the idle share of a PCG iteration, ``csr_spmv``
    against cuSPARSE on every level's A, R and P in f32, and at n = 12 the
    card against the CPU;
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
    ``poisson3d_p1`` at n = 32 on four shards of ``cuda:0`` against one;
13. multi-device (``phase_multi_device``): with two cards or more, the
    slab lattice GMG-CG at ``UnitCubeMesh(128)``, the sharded AMG-CG at
    274,625 dofs, ``HaloElementSolver``, the explicit march at 1,050,625
    nodes and K5's ``ShardedEllipticSolver``, each on 8 shards over every
    card and on one shard a card, held bit for bit (and in iterations)
    against the same shards stacked on ``cuda:0``, with ms an iteration,
    the bytes copied between cards, peer access and each card's launches;
    with one card, a check that ``config.shard_devices()`` puts every shard
    on ``cuda:0``.  ``python3 chip_smoke.py --only multi-device`` runs the
    build and this phase alone (on a machine with several cards).

Kernel times in the kernels' record are those of the dtype and mask of
the path that launches the kernel: K2 f64 all-Dirichlet (the transient
heat path, whose launches the record counts),
K1 (all-Dirichlet mask) and K3 f32 (the lattice path, in the bench's
dtype), K4 f64 (the CSR path), K5 f64 at k = 4 (the sharded Poisson path),
``csr_spmv`` f64 on the cantilever's AMG level 0 (its launches: the
elasticity ``main()``), K1-bf16 at 129^3 all-Dirichlet (its launches: the
bf16 refinement solve).  ``lattice_launches`` counts K1 and K2 in the
lattice runs of 8h, ``bench_bf16_launches`` and
``bench_unstructured_launches`` each kernel in the runs of 9b.
``ms``, ``plain_ms`` and ``library_ms`` are medians with the L2 flushed
before each run; ``bound_ms`` is the larger of the modelled bytes (each
input read once, each output written once: ``k1_bytes`` .. ``k5_bytes``)
over ``HBM_BYTES_PER_S`` and the operations over ``PEAK_FLOPS``.
``library_case`` says what ``library_ms`` times and ``library_kernel_ms``
is the kernel on that same case: for K2, ``F.conv3d`` on the same x,
which computes the unmasked apply (so it stands beside the unmasked
kernel, not the masked ``ms``); for K5, the ``einsum`` of its plain
version on the same case; for K4, one ``torch.einsum`` of its whole
function (``p1_stiffness_einsum``) on K4's case, held to the plain version
first; K1 and K3 have no single PyTorch call (null, with the reason).

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
    # K1's bf16-storage instance: the bench's bf16 refinement solve
    "stencil_apply_var_bf16": ("fenicssolver_tpu_torch/csrc/stencil.cu",
                               "fenicssolver_tpu/ops/pallas_kernels.py:308"),
    "stencil_apply_const": ("fenicssolver_tpu_torch/csrc/stencil.cu",
                            "fenicssolver_tpu/ops/pallas_kernels.py:363"),
    "p1_stiffness_sym": ("fenicssolver_tpu_torch/csrc/p1_stiffness.cu",
                         "fenicssolver_tpu/ops/pallas_kernels.py:144"),
    "p1_stiffness": ("fenicssolver_tpu_torch/csrc/p1_stiffness.cu",
                     "fenicssolver_tpu/ops/pallas_kernels.py:74"),
    "element_matvec": ("fenicssolver_tpu_torch/csrc/element_matvec.cu",
                       "fenicssolver_tpu/ops/pallas_kernels.py:28"),
    # not a TPU kernel: the repair of F5, in place of the reference's
    # segment_sum products of its AMG levels
    "csr_spmv": ("fenicssolver_tpu_torch/csrc/csr_spmv.cu",
                 "fenicssolver_tpu/la/amg.py:430"),
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
    cards = smi.stdout.strip().splitlines()
    card = cards[0]
    print(card)
    for i, other in enumerate(cards[1:], 1):
        print(f"[device] cuda:{i}: {other}")
    cpu = "unknown"
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            cpu = next((line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name")), cpu)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"using {torch.cuda.get_device_name(0)}; host CPU {cpu}, "
          f"{os.cpu_count()} cores")
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
    for path in paths:
        info = cuda_kernels.BUILD_INFO[path]
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
    staged = (f" ({plan['coef_smem_bytes']} B of it the staged coefficient "
              "tiles)" if plan["coef_smem_bytes"] else "")
    return (f"{plan['threads']} threads x {plan['outputs']} outputs, tile "
            f"{plan['R']} x {plan['W']} (j x k), {plan['tiles']} tiles a plane, "
            f"{plan['chunk']} planes a block, {plan['blocks']} blocks, "
            f"{plan['smem_bytes']} B shared{staged}")


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


def k1_bf16_bytes(shape):
    """K1 with bf16 storage: the 15 tap fields, x and the mask read, y
    written, 2 B each."""
    return (15 + 3) * math.prod(shape) * 2


def k1_bf16_flops(shape):
    """The masked K1's operations and the identity rows: 1 - f, its product
    with x and the sum, per vertex (all f32)."""
    return stencil_flops(shape) + 3 * math.prod(shape)


def bf16_ulps(y, ref):
    """The largest |y - ref| over one bf16 ulp of ``ref`` (the spacing of
    bf16 values at |ref|, normal range)."""
    import torch

    r = ref.float().abs().clamp(min=2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(r)) - 7)
    return float(((y.float() - ref.float()).abs() / ulp).max())


def _bf16_operands(shape, device, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(shape), device=device)
    c = torch.as_tensor(rng.standard_normal((15,) + shape), device=device)
    return x.to(torch.bfloat16), c.to(torch.bfloat16)


def phase_k1_bf16(device="cuda", shapes=STENCIL_SHAPES, n=N_MAIN):
    """K1's bf16-storage instance (``stencil_apply_var_bf16``) against its
    plain version over ``STENCIL_SHAPES``, each mask of ``stencil_masks``
    (all ones for "no mask": the instance is masked), random bf16 taps and
    x, and a misaligned x: every output within one bf16 ulp of the plain
    version's (both sum in f32 in one order; only the FMA contraction
    differs).  Then timed at (n + 1)^3 all-Dirichlet beside the f32 K1 on
    the same values (no single PyTorch call computes it).  Returns the
    timed dict with ``max_abs_err``, ``max_ulps`` and ``f32_ms``."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels

    bf16 = torch.bfloat16
    worst_ulps, worst_err = 0.0, 0.0
    for shape in shapes:
        x, c = _bf16_operands(shape, device, sum(shape) + 2)
        ulps = []
        for mname, m_np in stencil_masks(shape, seed=sum(shape)):
            f = torch.as_tensor(np.ones(shape) if m_np is None else m_np,
                                device=device).to(bf16)
            for what, xk in (("", x), (" misaligned", _misaligned(x))):
                y_p = cuda_kernels.stencil_apply_var_bf16_reference(x, c, f)
                y_k = cuda_kernels.stencil_apply_var_bf16(xk, c, f)
                torch.cuda.synchronize()
                u = bf16_ulps(y_k, y_p)
                worst_ulps = max(worst_ulps, u)
                worst_err = max(worst_err,
                                float((y_k.float() - y_p.float()).abs().max()))
                check(u <= 1.0, f"k1-bf16 {mname}{what} {shape}: {u} bf16 "
                      "ulps from the plain version")
                ulps.append(f"{mname}{what} {u:.2f}")
        plan = cuda_kernels.stencil_plan(x, f, c)
        print(f"[k1-bf16] {shape}: bf16 ulps from the plain version "
              f"{', '.join(ulps)} (tol 1); {plan_text(plan)}")
        del x, c, f
    shape = (n + 1,) * 3
    x, c = _bf16_operands(shape, device, 3)
    f = torch.as_tensor(dict(stencil_masks(shape))["all-dirichlet"],
                        device=device).to(bf16)
    t = _timed("k1-bf16", f"bf16 all-dirichlet {shape}",
               lambda: cuda_kernels.stencil_apply_var_bf16(x, c, f),
               lambda: cuda_kernels.stencil_apply_var_bf16_reference(x, c, f),
               k1_bf16_bytes(shape), k1_bf16_flops(shape), "float32")
    x32, c32, f32 = x.float(), c.float(), f.float()
    f32_ms = time_ms(lambda: cuda_kernels.stencil_apply_var(x32, c32, f32),
                     flush=True)
    print(f"[k1-bf16] {shape}: {plan_text(cuda_kernels.stencil_plan(x, f, c))}; "
          f"the f32 K1 on the same values {f32_ms:.4f} ms "
          f"flushed ({k1_bytes(shape, 4):,} B; "
          f"{plan_text(cuda_kernels.stencil_plan(x32, f32, c32))}); bf16 / f32 "
          f"time {t['ms'] / f32_ms:.3f}; max {worst_ulps:.2f} bf16 ulps over "
          "the sweep")
    t.update(max_abs_err=worst_err, max_ulps=worst_ulps, f32_ms=f32_ms,
             library_ms=None, library_kernel_ms=None,
             library_case="none: the taps differ at each vertex")
    return t


def _compare(tag, what, kernel, plain, nbytes, flops, dtype_name, tol,
             library=False, library_case=None):
    """Kernel against plain version on the same inputs, then ``_timed``;
    ``library``: True when the plain version is itself one PyTorch call (its
    time is also the library time), or that one call (timed beside the
    kernel on the same inputs after ``_agree`` holds it to the plain
    version too; ``library_case`` says what it is).  Returns ``_timed``'s
    dict with the max abs error."""
    abs_err, _ = _agree(tag, what, kernel, plain, tol)
    if callable(library):
        lib_err, _ = _agree(tag, f"{what} library", library, plain, tol)
        t = _timed(tag, what, kernel, plain, nbytes, flops, dtype_name,
                   library=library)
        t.update(library_kernel_ms=t["ms"],
                 library_case=f"{library_case}; same case, max abs err "
                              f"{lib_err:.1e} against the plain version")
    elif library:
        t = _timed(tag, what, kernel, plain, nbytes, flops, dtype_name)
        t.update(library_ms=t["plain_ms"], library_kernel_ms=t["ms"],
                 library_case="the plain version, one torch.einsum; same case")
    else:
        t = _timed(tag, what, kernel, plain, nbytes, flops, dtype_name)
        t.update(library_kernel_ms=None, library_case=library_case
                 or "none: no single PyTorch call computes it")
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


#: what K4's library call computes: the whole of K4's function
K4_LIBRARY_CASE = ("torch.einsum('c,at,tdc,bs,sdc->abc', |detJ|/d!, gref, "
                   "JinvT, gref, JinvT)")
#: why K3 has none: the einsum gives the full 4 x 4 matrices
K3_LIBRARY_CASE = ("none: one einsum gives the full 4 x 4 matrices; the "
                   "packing to K3's 10 SYM10 entries takes a second call")


def p1_stiffness_einsum(JinvT, detJ, gref):
    """K4's function as one ``torch.einsum`` on its inputs: (k, k, nc)
    element matrices |detJ|/d! G G^T with G = gref JinvT."""
    import math as _math

    import numpy as np
    import torch

    g = torch.as_tensor(np.asarray(gref, dtype=np.float64), dtype=JinvT.dtype,
                        device=JinvT.device)
    scale = detJ * (1.0 / _math.factorial(g.shape[1]))
    return lambda: torch.einsum("c,at,tdc,bs,sdc->abc", scale, g, JinvT, g,
                                JinvT)


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
                lib, case = None, None
                if kname == "p1_stiffness" and dim == 3 and name == "float64":
                    lib, case = p1_stiffness_einsum(JinvT, detJ, gref), \
                        K4_LIBRARY_CASE
                elif kname == "p1_stiffness_sym":
                    case = K3_LIBRARY_CASE
                r = _compare("k3" if kname == "p1_stiffness_sym" else "k4",
                             f"{what} {name} nc={nc}", kern, plain, nbytes,
                             flops, name, TOL[name], library=lib,
                             library_case=case)
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


def phase_bench_bf16(device="cuda", n=N_MAIN):
    """``bench.py``'s bf16 refinement solve: ``run_stencil(n)`` in f32, then
    ``run_stencil(n, bf16=True)`` (the launch counts reset just before it
    and read just after), each twice (the second timed); the bf16 u_max
    within 1e-3 of the f32 one (the bench's rule), K1's bf16 instance and
    the f32 K1 and K2 launched; the bench's own variant, its inner iterate
    stored in bf16 (``bf16_iterate=True``, R15), once, printed beside it;
    then K1-bf16 against its plain version on the solver's own fields: the
    assembled taps in bf16, the Dirichlet shell, the bf16 solution as x (a
    smooth field: the taps cancel), within one bf16 ulp.  Returns the bf16
    run's launch counts."""
    import torch

    from fenicssolver_tpu_torch.lattice_poisson import run_stencil
    from fenicssolver_tpu_torch.ops import cuda_kernels
    from fenicssolver_tpu_torch.ops.stencil_assembly import (
        assemble_stencil,
        box_geometry,
    )

    f32 = torch.float32
    r32 = run_stencil(n, dtype=f32, device=device)
    cuda_kernels.reset_launch_counts()
    rbf = run_stencil(n, bf16=True, device=device)
    launches = dict(cuda_kernels.LAUNCHES)
    r32b = run_stencil(n, dtype=f32, device=device)
    rbfb = run_stencil(n, bf16=True, device=device)
    ref = run_stencil(n, bf16=True, bf16_iterate=True, device=device)
    rel = abs(rbf["u_max"] - r32["u_max"]) / abs(r32["u_max"])
    rel_ref = abs(ref["u_max"] - r32["u_max"]) / abs(r32["u_max"])
    ratio = rbfb["solve_s"] / r32b["solve_s"]
    print(f"[bench-bf16] run_stencil({n}, bf16=True): {rbf['ndof']} dofs, "
          f"{rbf['passes']} refinement passes x {rbf['inner_iters']} bf16 PCG "
          f"iterations = {rbf['iterations']}, true f32 rel residual "
          f"{rbf['relres']:.3e}, u_max {rbf['u_max']:.10f} against f32's "
          f"{r32['u_max']:.10f} (rel {rel:.2e}, tol 1e-3; f32 "
          f"{r32['iterations']} CG iterations, rel residual "
          f"{r32['relres']:.3e})")
    print(f"[bench-bf16] solve: bf16 {rbf['solve_s'] * 1e3:.2f} ms, then "
          f"{rbfb['solve_s'] * 1e3:.2f} ms; f32 {r32['solve_s'] * 1e3:.2f} ms, "
          f"then {r32b['solve_s'] * 1e3:.2f} ms; bf16 / f32 (the second runs) "
          f"{ratio:.3f}; assembly bf16 {rbfb['assembly_s'] * 1e3:.2f} ms, f32 "
          f"{r32b['assembly_s'] * 1e3:.2f} ms; launches {launches}")
    print(f"[bench-bf16] the bench's variant (its inner iterate in bf16, "
          f"R15): {ref['passes']} passes, true f32 rel residual "
          f"{ref['relres']:.3e}, u_max rel {rel_ref:.2e} from f32's (the "
          f"bench's rule: 1e-3), solve {ref['solve_s'] * 1e3:.2f} ms")
    check(rel <= 1e-3, f"bf16 u_max {rbf['u_max']} vs f32 {r32['u_max']}")
    check(rbfb["iterations"] == rbf["iterations"],
          f"two bf16 solves: {rbf['iterations']} and {rbfb['iterations']}")
    for k in ("stencil_apply_var_bf16", "stencil_apply_var",
              "stencil_apply_const", "p1_stiffness_sym"):
        check(launches[k] > 0, f"{k} was not launched by the bf16 solve")
    JinvT, detJ = box_geometry((n, n, n), dtype=f32, device=device)
    coef, _ = assemble_stencil(JinvT, detJ, (n, n, n), mode="sym")
    del JinvT, detJ
    bf = torch.bfloat16
    c, x = coef.to(bf), rbf["u"].view(coef.shape[1:]).to(bf)
    f = torch.zeros_like(x)
    f[1:-1, 1:-1, 1:-1] = 1
    y_p = cuda_kernels.stencil_apply_var_bf16_reference(x, c, f)
    y_k = cuda_kernels.stencil_apply_var_bf16(x, c, f)
    torch.cuda.synchronize()
    ulps = bf16_ulps(y_k, y_p)
    inner = (slice(1, -1),) * 3
    cancel = float(y_p[inner].float().abs().max() / x[inner].float().abs().max())
    print(f"[bench-bf16] K1-bf16 on the solver's fields {tuple(x.shape)}: "
          f"{ulps:.2f} bf16 ulps from the plain version (tol 1), max abs err "
          f"{float((y_k.float() - y_p.float()).abs().max()):.3e}; |A x| / |x| "
          f"on the free rows {cancel:.2e}")
    check(ulps <= 1.0, f"K1-bf16 on the solver's fields: {ulps} ulps")
    return {"launches": launches}


def phase_bench_unstructured(device="cuda", n=100, n_check=12):
    """``bench.py``'s unstructured path: ``run_unstructured(n)`` (the launch
    counts reset just before it and read just after), res <= 1e-6 within
    500 iterations; the set-up by step, the levels, the seconds, the
    ``csr_spmv`` launches, the device idle share of ten PCG iterations; then
    ``csr_spmv`` against cuSPARSE (its plain version) on every level's A,
    R and P in f32; and at ``n_check`` the card against the CPU (equal
    iterations, u_max within 1e-5 relative).  Returns the launches and the
    fine operator's ``_compare`` dict."""
    import torch

    from fenicssolver_tpu_torch.lattice_poisson import run_unstructured
    from fenicssolver_tpu_torch.ops import cuda_kernels

    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = run_unstructured(n, device=device)
    wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    solver, b = r["solver"], r["b"]
    print(f"[bench-unstructured] run_unstructured({n}): {r['ndof']} dofs "
          f"({r['nfree']} free), f32, levels {r['levels']}: {r['iters']} PCG "
          f"iterations, res {r['res']:.3e}, umax {r['umax']:.10f}, timed solve "
          f"{r['dt'] * 1e3:.2f} ms ({r['dt'] / max(r['iters'], 1) * 1e3:.3f} ms "
          f"an iteration), set-up {r['setup_s']:.2f} s: " + ", ".join(
              f"{k} {v:.2f}" for k, v in r["setup_steps"].items())
          + f"; whole call {wall:.2f} s; csr_spmv launches "
          f"{launches['csr_spmv']}; peak {_peak_gib():.2f} GiB")
    check(r["res"] <= 1e-6 and r["iters"] < 500,
          f"unstructured: {r['iters']} iterations, res {r['res']}")
    check(launches["csr_spmv"] > 0, "csr_spmv was not launched")
    iters = 10
    solver(b, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solver(b, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t1) / iters * 1e3
    prof = _profiled(lambda: solver(b, tol=0.0, maxiter=iters), 1)
    busy = "not measured" if prof is None else (
        f"device busy {prof[0] / iters:.4f} ms an iteration ({prof[2] / iters:.0f}"
        f" device events), idle {100 * (1 - prof[0] / iters / it_ms):.1f}%")
    print(f"[bench-unstructured] a PCG iteration {it_ms:.3f} ms wall "
          f"(synchronised, {iters} iterations); {busy}")
    ops = [(f"level {li} {k}", m[k]) for li, m in enumerate(solver.levels)
           for k in ("A", "R", "P")]  # level 0's A is the PCG operator
    fine = None
    for name, M in ops:
        ip, ix, data = M.indptr, M.indices, M.data
        gen = torch.Generator(device=data.device).manual_seed(7)
        x = torch.randn(M.shape[1], generator=gen, dtype=data.dtype,
                        device=data.device)
        args = (ip, ix, data, x, M.shape)
        t = _compare(
            "bench-unstructured", f"csr_spmv {name} {M.shape}, "
            f"{data.numel()} nnz ({data.numel() / M.shape[0]:.1f} a row), "
            + spmv_group_text(cuda_kernels.spmv_plan(
                M.shape[0], M.shape[1], data.numel())) + ", f32",
            lambda: cuda_kernels.csr_spmv(*args),
            lambda: cuda_kernels.csr_spmv_reference(*args),
            spmv_bytes(M.shape[0], M.shape[1], data.numel(), 4),
            2 * data.numel(), "float32", TOL["float32"],
            library=lambda: cuda_kernels.csr_spmv_reference(*args),
            library_case="torch.sparse_csr_tensor @ x (cuSPARSE), which is "
                         "the plain version")
        fine = fine or t
    del solver, b, r
    res = {}
    for where in (device, "cpu"):
        res[where] = run_unstructured(n_check, device=where)
    g, c = res[device], res["cpu"]
    rel = abs(g["umax"] - c["umax"]) / abs(c["umax"])
    print(f"[bench-unstructured] n = {n_check}: {g['ndof']} dofs, levels "
          f"{g['levels']}: card {g['iters']} iterations, cpu {c['iters']}; "
          f"umax rel {rel:.2e} (tol 1e-5)")
    check(g["iters"] == c["iters"] and rel <= 1e-5,
          f"unstructured {n_check}: {g['iters']} vs {c['iters']} iterations, "
          f"umax rel {rel}")
    return {"launches": launches, "spmv": fine}


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
    return {"launches": launches, "iterations": solver.last_iterations, "V": V,
            "T": T}


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
    active: the phase times it added, whether it kept A, its iterations, the
    K2 launches it made and (``keep``) a copy of the solution."""

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
            kept = solver.timers.counts["operator_kept"]
            k2 = cuda_kernels.LAUNCHES["stencil_apply_const"]
            inner(solver)
            probe.steps.append({
                "kept": solver.timers.counts["operator_kept"] > kept,
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
    line a step (form build or cached-form refresh, assembly with A kept or
    rebuilt, GMG setup, Krylov, iterations, K2 launches); checks the CN decay
    of the sine mode, <= 60 iterations and K2 launches on every step, one
    form build and A kept on every later step; then ``profile_form`` and
    ``profile_pattern``.  Returns the launches, the iterations, the solver
    and the last step's solution."""
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
              f"s (A {'kept, b alone' if st['kept'] else 'and b built'}), gmg "
              f"setup {t['gmg_setup']:.2f} s, krylov {t['krylov']:.3f} "
              f"s, {st['iterations']} CG iterations, K2 launches {st['k2']}, "
              f"max|T - (300 + 60 z) - 10 g^{k + 1} mode| = {err:.3e}")
        check(isinstance(st["iterations"], int) and st["iterations"] <= 60,
              f"step {k}: iterations {st['iterations']} > 60")
        check(err <= 1e-2, f"step {k}: decay error {err} > 1e-2")
        if on_cuda:
            check(st["k2"] > 0, f"step {k}: K2 was not launched")
    check(len(probe.steps) == steps, f"{len(probe.steps)} steps, not {steps}")
    check(hasattr(solver, "_gmg_cache"), "the GMG branch did not run")
    counts = solver.timers.counts
    check(counts["form"] == 1 and counts["form_cache_refresh"] == steps - 1
          and counts["operator_kept"] == steps - 1,
          f"not one form build, then a refresh with A kept on every later "
          f"step: {dict(counts)}")
    profile_form(solver)
    if on_cuda:
        profile_pattern(solver._transient_form_cache[0][0])
    return {"launches": launches,
            "iterations": [st["iterations"] for st in probe.steps],
            "solver": solver, "T": probe.steps[-1]["T"]}


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


def profile_pattern(form, n_host=64):
    """The CSR pattern of ``form``'s dof maps built on the card
    (``torch.unique`` of the keys), timed at the form's size; and, for the
    P1 dof map of ``UnitCubeMesh(n_host)``, the card's route beside the host
    route (copy to the host, numpy keys, ``native.build_csr_pattern``): the
    two must be identical.  The host route is held at ``n_host`` because its
    sort takes most of a minute at n = 128."""
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la import sparse

    def build(maps, ndof, dev, on_device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = sparse.build_pattern(maps, ndof, device=dev, on_device=on_device)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _peak_gib()

    maps = [t.ctx.cell_dofs for t in form.cell_terms + form.facet_terms]
    ndof, dev = form.space.ndof, maps[0].device
    entries = sum(m.shape[0] * m.shape[1] ** 2 for m in maps)
    (pf, _), full_s, full_peak = build(maps, ndof, dev, True)
    V = core.FunctionSpace(core.UnitCubeMesh(n_host, n_host, n_host), "CG", 1)
    small = [torch.as_tensor(V.cell_dofs.astype("int64"), device=dev)]
    (pc, posc), card_s, _ = build(small, V.ndof, dev, True)
    (ph, posh), host_s, _ = build(small, V.ndof, dev, False)
    same = (all(torch.equal(getattr(pc, f), getattr(ph, f))
                and getattr(pc, f).dtype == torch.int32
                for f in ("indptr", "indices", "rows"))
            and all(torch.equal(a, b) for a, b in zip(posc, posh))
            and pc.nnz == ph.nnz)
    print(f"[pattern] {ndof} dofs, {entries:,} element entries, {pf.nnz:,} "
          f"stored: on the card {full_s:.3f} s (peak device memory "
          f"{full_peak:.2f} GiB in it); at n = {n_host} ({V.ndof} dofs, "
          f"{pc.nnz:,} stored): on the card {card_s:.3f} s, on the host "
          f"{host_s:.2f} s (copy, numpy keys, native sort); identical: {same}")
    check(same, "the card's CSR pattern differs from the host's")


def phase_determinism(solver, device="cuda"):
    """Assembly on the card sums in a fixed order: two assemblies of the
    transient solver's cached form are bit-equal (A's data and b).  Beside
    it, what the order costs: the assembly with ``index_add_``'s atomics
    (the same form finalized with ``ordered=False``), and one chunk's
    scatter of 2^24 values into 32 M slots by ``index_add_``, by
    ``index_put_(accumulate=True)`` (which sorts at every call), by
    ``torch.segment_reduce`` over the presorted values and by the presorted
    ``OrderedScatter`` (a CSR selection product).  Repeated CSR products
    must be bit-equal too (iteration counts repeat only if they are).  The
    digests of A and b can be compared between two calls of the script."""
    import hashlib

    import torch

    from fenicssolver_tpu_torch.ops import assembly

    form = solver._transient_form_cache[0][0]
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    times = {}
    for ordered in (True, False):
        if not ordered:
            form.finalize(ordered=False)
        runs = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            runs.append(assembly.assemble_linear_system(form))
            sync()
            times[ordered] = time.perf_counter() - t0
        (A0, b0), (A1, b1) = runs
        equal = torch.equal(A0.data, A1.data) and torch.equal(b0, b1)
        digest = " ".join(
            hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:12]
            for t in (A0.data, b0))
        print(f"[determinism] assembly of A and b, "
              f"{'fixed order' if ordered else 'index_add_ (atomics)'}: "
              f"{times[ordered]:.3f} s; two assemblies bit-equal: {equal}; "
              f"sha256 of A's data and of b: {digest}")
        if ordered:
            check(equal, "two assemblies on the card differ")
            x = torch.randn(A0.pattern.n, dtype=A0.data.dtype, device=device,
                            generator=torch.Generator(device=device).manual_seed(5))
            ys = [A0 @ x for _ in range(20)]
            spmv = all(torch.equal(ys[0], y) for y in ys)
            print(f"[determinism] 20 CSR products of A bit-equal: {spmv}")
            check(spmv, "repeated CSR products differ")
            del ys
        del runs, A0, A1, b0, b1
    form.finalize()
    if torch.device(device).type != "cuda":
        return
    n_out, n_in = 32_000_000, 1 << 24
    gen = torch.Generator(device=device).manual_seed(0)
    idx = torch.randint(0, n_out // 12, (n_in,), generator=gen, device=device)
    vals = torch.randn(n_in, dtype=torch.float64, device=device, generator=gen)
    out = torch.zeros(n_out, dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    sc = assembly.OrderedScatter(idx)
    sync()
    setup = time.perf_counter() - t0
    lengths = sc.crow[1:] - sc.crow[:-1]
    ms = {
        "index_add_": time_ms(lambda: out.index_add_(0, idx, vals), reps=10),
        "index_put_(accumulate=True)": time_ms(
            lambda: out.index_put_((idx,), vals, accumulate=True), reps=10),
        "segment_reduce of the presorted values": time_ms(
            lambda: out.index_add_(0, sc.targets, torch.segment_reduce(
                vals[sc.cols], "sum", lengths=lengths, unsafe=True)), reps=10),
        "OrderedScatter": time_ms(lambda: sc.add_(out, vals), reps=10),
    }
    print(f"[determinism] one chunk's scatter ({n_in:,} f64 values): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; OrderedScatter's one-time sort {setup * 1e3:.1f} ms")


class CountCG:
    """Records the iterations of every ``la/krylov.cg`` call while active,
    and the operator, right-hand side and keyword arguments of the last."""

    def __enter__(self):
        from fenicssolver_tpu_torch.la import krylov

        self.krylov, self.inner, self.iterations = krylov, krylov.cg, []
        self.last = None

        def cg(A, b, **kwargs):
            self.last = (A, b, kwargs)
            x, it, res = self.inner(A, b, **kwargs)
            self.iterations.append(it)
            return x, it, res

        krylov.cg = cg
        return self

    def __exit__(self, *exc):
        self.krylov.cg = self.inner


def phase_fast_path(device="cuda", n=N_MAIN, V=None, T_loop=None, steps=3,
                    long_steps=10):
    """``fast_paths.compile_transient_heat`` on the transient phase's
    settings: ``steps`` steps of ``DT`` at ``RTOL`` (setup seconds, seconds
    and Jacobi-PCG iterations a step), ``T_final`` against the time loop's
    solution after as many steps ``T_loop`` (rel-L2 <= 1e-7) and against the
    CN decay of the sine mode (1e-2); then ``long_steps`` steps for the time
    a step."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.solvers import fast_paths
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    on_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    if V is None:
        V = core.FunctionSpace(core.UnitCubeMesh(n, n, n), "CG", 1)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    x = V.dof_coords
    base = 300.0 + 60.0 * x[:, 2]
    mode = 10.0 * np.prod(np.sin(np.pi * x), axis=1)
    g = (1 - 1.5 * np.pi**2 * DT) / (1 + 1.5 * np.pi**2 * DT)
    for count in (steps, long_steps):
        sync()
        t0 = time.perf_counter()
        solver = ScalarTransportSolver(transient_settings(core, V, count),
                                       device=device)
        run, aux = fast_paths.compile_transient_heat(solver, DT, count, tol=RTOL)
        T0 = solver.get_initial_field().values
        sync()
        t1 = time.perf_counter()
        with CountCG() as cg:
            T, norms = run(T0)
            sync()
        t2 = time.perf_counter()
        T = T.cpu().numpy()
        norms = norms.cpu().numpy()
        err = float(np.abs(T - base - g**count * mode).max())
        its = cg.iterations
        peak = _peak_gib() if on_cuda else float("nan")
        print(f"[fast-path] n={n}: {V.ndof} dofs, {count} CN steps of {DT:g} at "
              f"tol {RTOL:g} on {device}: setup (solver, two forms, A, K, b) "
              f"{t1 - t0:.2f} s; run {t2 - t1:.3f} s, {(t2 - t1) / count:.4f} s a "
              f"step, Jacobi-PCG iterations a step {min(its)}-{max(its)} (mean "
              f"{sum(its) / len(its):.1f}), {(t2 - t1) / sum(its) * 1e3:.3f} ms an "
              f"iteration; |T| {norms[0]:.6e} -> {norms[-1]:.6e}; max|T - (300 + "
              f"60 z) - 10 g^{count} mode| = {err:.3e}; peak device memory "
              f"{peak:.2f} GiB")
        check(len(its) == count and norms.shape == (count,), "steps not taken")
        check(np.isfinite(T).all(), "fast path: non-finite solution")
        check(err <= 1e-2, f"fast path: decay error {err} > 1e-2")
        check(abs(norms[-1] - np.linalg.norm(T)) <= 1e-9 * norms[-1],
              "fast path: the last norm is not |T_final|")
        if count == steps and T_loop is not None:
            rel = _rel_l2(T, T_loop)
            print(f"[fast-path] T_final vs the time loop's step {steps}: rel-L2 "
                  f"{rel:.3e} (tol 1e-7)")
            check(rel <= 1e-7, f"fast path vs the time loop rel-L2 {rel}")
        del run, aux, solver


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


def advection_case(core, V):
    """``test_convective_velocity_supg``'s settings on ``V``: capacity 1,
    k 0.6, v = (0, 0, -0.6), ``"SPUG"``, Pe 1."""
    return scalar_settings(core, V, {"capacity": 1.0, "conductivity": 0.6},
                           convective_velocity=(0.0, 0.0, -0.6),
                           advection_settings={"stabilization_method": "SPUG",
                                               "Pe": 1.0})


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
    t0 = time.perf_counter()
    solver = run_main(advection_case(core, V), device=device)
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


def phase_transient_cli(on="cuda"):
    """Transient copies of ``data/TestHeatTransfer.json`` (the file is not
    edited) through ``python -m fenicssolver_tpu_torch`` with ``FST_DEVICE``
    unset (``on="cpu"``: set to ``cpu``): P1 and P2, the DG solver, and P1
    restarted from a checkpoint of the steady solution on the case's mesh
    (``initial_values`` names the ``.npz``).  Each runs its three steps on
    the card; the restarted run, starting from the steady state, must stay
    on it."""
    import tempfile

    from fenicssolver_tpu_torch.io import checkpoint
    from fenicssolver_tpu_torch.main import load_settings, main as run_main

    env = {k: v for k, v in os.environ.items() if k != "FST_DEVICE"}
    env["PYTHONPATH"] = HERE
    if on == "cpu":
        env["FST_DEVICE"] = "cpu"
    json_case = os.path.join(HERE, "data", "TestHeatTransfer.json")
    steady = run_main(load_settings(json_case), device=on)
    cases = (("P1", {"fe_degree": 1}), ("P2", {"fe_degree": 2}),
             ("DG1", {"solver_name": "ScalarTransportDGSolver"}),
             ("P1 restarted", {"restart": True}))
    top = tempfile.TemporaryDirectory()
    runs = []
    for k, (name, change) in enumerate(cases):
        settings = load_settings(json_case)
        restart = change.pop("restart", False)
        settings.update(change)
        settings["solver_settings"]["transient_settings"]["transient"] = True
        tmp = os.path.join(top.name, str(k))
        os.makedirs(tmp)
        if restart:
            ckpt = os.path.join(tmp, "steady.npz")
            checkpoint.save_function(ckpt, steady.result)
            settings["initial_values"] = {"temperature": ckpt}
            settings["report_settings"].update(
                saving_freq=3, result_filename=os.path.join(tmp, "T.pvd"))
        case = os.path.join(tmp, "case.json")
        with open(case, "w") as f:
            json.dump(settings, f)  # the mesh path is absolute here
        runs.append((name, restart, tmp, case))

    def cli(run):
        # the four processes share the card at once: each spends most of its
        # ~20 s starting up on the host
        return subprocess.run(
            [sys.executable, "-m", "fenicssolver_tpu_torch", run[3]],
            cwd=run[2], env=env, capture_output=True, text=True, timeout=600)

    with ThreadPoolExecutor(len(runs)) as pool:
        procs = list(pool.map(cli, runs))
    for (name, restart, tmp, _), proc in zip(runs, procs):
        drift = None
        if restart and proc.returncode == 0:
            vals = _pvd_last_values(os.path.join(tmp, "T.pvd"), "f")
            drift = _rel_l2(vals, steady.result.values)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        print(f"[transient-cli] {name}, FST_DEVICE "
              f"{'unset' if on != 'cpu' else 'cpu'}: rc {proc.returncode}; {line}"
              + ("" if drift is None else
                 f"; after 3 steps from the steady state rel-L2 {drift:.3e} "
                 "from it (tol 1e-8)"))
        check(proc.returncode == 0, f"{name} transient CLI: {proc.stderr[-2000:]}")
        check(f" on {on}" in line and "3 time steps" in line,
              f"{name} transient CLI did not run 3 steps on {on}")
        if restart:
            check(drift <= 1e-8, f"restarted run left the steady state: {drift}")
    top.cleanup()


def _pvd_last_values(pvd, name):
    """The point data ``name`` of the last data set of a PVD file."""
    import xml.etree.ElementTree as ET

    import numpy as np

    sets = [d.attrib for d in ET.parse(pvd).getroot().iter("DataSet")]
    vtu = ET.parse(os.path.join(os.path.dirname(pvd), sets[-1]["file"])).getroot()
    arr = next(a for a in vtu.iter("DataArray") if a.attrib.get("Name") == name)
    return np.array(arr.text.split(), dtype=np.float64)


def dg_settings(core, n, material, **extra):
    """``scalar_settings`` for ``ScalarTransportDGSolver`` on
    ``UnitCubeMesh(n)``, DG1 (the solver builds its spaces from the mesh)."""
    s = scalar_settings(core, None, material, **extra)
    s.update(mesh=core.UnitCubeMesh(n, n, n), function_space=None, fe_degree=1,
             solver_name="ScalarTransportDGSolver")
    s["solver_settings"]["solver_parameters"]["maximum_iterations"] = 50000
    return s


def phase_dg(device="cuda", n=32):
    """``ScalarTransportDGSolver`` through ``main`` on ``UnitCubeMesh(n)``,
    DG1: SIPG diffusion (penalty alpha = 500) against the linear profile,
    and upwind advection (the case of ``phase_advection``) against the exact
    exponential profile, both read on the CG shadow space.  The reference
    solves these by Jacobi Krylov on the assembled CSR matrix."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    lam = -0.6 / 0.6
    cases = (
        ("SIPG diffusion", {}, ("CG",), 1e-6,
         lambda z: 300.0 + 60.0 * z),
        ("upwind advection", {"convective_velocity": (0.0, 0.0, -0.6)},
         ("BiCGStab", "GMRES"), 1e-3,
         lambda z: 300.0 + 60.0 / (np.exp(lam) - 1.0) * (np.exp(lam * z) - 1.0)),
    )
    for name, extra, methods, tol, exact in cases:
        s = dg_settings(core, n, {"capacity": 1.0, "conductivity": 0.6}, **extra)
        t0 = time.perf_counter()
        solver = run_main(s, device=device)
        wall = time.perf_counter() - t0
        tt = solver.timers.totals
        err = _rel_l2(solver.result.values,
                      exact(solver.shadow_space.dof_coords[:, 2]))
        print(f"[dg] {name} n={n}: {solver.function_space.ndof} DG1 dofs, "
              f"{solver.mesh.num_cells()} tets on {device}, {solver.last_krylov} "
              f"{solver.last_iterations} iterations (rel residual "
              f"{solver.last_relres:.3e}); form {tt['form']:.2f} s, assembly "
              f"{tt['assembly']:.2f} s, krylov {tt['krylov']:.2f} s, main() "
              f"{wall:.2f} s; projected to CG, rel-L2 vs the exact profile "
              f"{err:.3e} (tol {tol:g})")
        check(type(solver).__name__ == "ScalarTransportDGSolver"
              and solver.function_space.family == "DG", "not the DG solver")
        check(solver.last_krylov in methods, f"{name} solved by {solver.last_krylov}")
        check(err <= tol, f"{name} rel-L2 {err}")


def phase_periodic(device="cuda", n=256):
    """tests/test_periodic.py's case refined to n x n: T = 360 at y = 1, 300
    at y = 0, the x = 1 edge tied to x = 0 (``periodic_boundary`` in the
    settings) and a source that is not symmetric in x, by Jacobi-CG; the
    two edges must agree to 1e-8 and the field vary in x."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    class PeriodicX(core.SubDomain):
        def inside(self, x, on_boundary):
            return core.near(x[0], 0.0)

        def map(self, x, y):
            y[0] = x[0] - 1.0
            y[1] = x[1]

    s = scalar_settings(core, None, {"thermal_conductivity": 0.6},
                        body_source=core.Expression("100*sin(2*pi*x[0] + 0.5)",
                                                    degree=2))
    for bc, axis_value in (("cold", 0.0), ("hot", 1.0)):  # y, not z, in 2-D
        s["boundary_conditions"][bc]["boundary"] = core.AutoSubDomain(
            lambda x, v=axis_value: core.near(x[1], v))
    s.update(mesh=core.UnitSquareMesh(n, n), function_space=None,
             periodic_boundary=PeriodicX())
    s["solver_settings"]["solver_parameters"]["maximum_iterations"] = 20000
    t0 = time.perf_counter()
    solver = run_main(s, device=device)
    wall = time.perf_counter() - t0
    V = solver.function_space
    T, X = solver.result.values, V.dof_coords
    inner = (X[:, 1] > 1e-9) & (X[:, 1] < 1 - 1e-9)
    left = np.nonzero(core.near(X[:, 0], 0.0) & inner)[0]
    right = np.nonzero(core.near(X[:, 0], 1.0) & inner)[0]
    left, right = left[np.argsort(X[left, 1])], right[np.argsort(X[right, 1])]
    gap = float(np.abs(T[left] - T[right]).max())
    swing = float(np.ptp(T[np.abs(X[:, 1] - 0.5) < 1e-9]))
    print(f"[periodic] {n} x {n}: {V.ndof} dofs, {len(V.periodic_slaves)} slaves "
          f"on {device}, {solver.last_krylov} {solver.last_iterations} iterations, "
          f"krylov {solver.timers.totals['krylov']:.2f} s, main() {wall:.2f} s "
          f"(the slave map is a host loop); max|T(0, y) - T(1, y)| = {gap:.3e} "
          f"(tol 1e-8), T varies by {swing:.3f} along y = 0.5")
    check(len(V.periodic_slaves) == n + 1, f"{len(V.periodic_slaves)} slaves")
    check(solver.last_krylov == "CG", f"solved by {solver.last_krylov}")
    check(np.isfinite(T).all() and gap <= 1e-8, f"periodic gap {gap}")
    check(swing > 0.01, "the periodic solution does not vary in x")


def phase_restart(device="cuda", n=16, n_other=12):
    """Checkpoints: two transient steps at n, ``save_state`` and
    ``save_function``; a fresh solver on the same mesh takes the state back
    (``load_state``); a solver on ``UnitCubeMesh(n_other)`` takes the saved
    field as its initial field by file name, interpolated, and takes the
    step that the same field handed over as a ``Function`` gives."""
    import tempfile

    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.io import checkpoint
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.ops.pointlocate import (
        interpolate_nonmatching_mesh,
    )
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    V = core.FunctionSpace(core.UnitCubeMesh(n, n, n), "CG", 1)
    first = run_main(transient_settings(core, V, 2), device=device)
    with tempfile.TemporaryDirectory() as tmp:
        state, field = (os.path.join(tmp, f) for f in ("state.npz", "T.npz"))
        checkpoint.save_state(state, first)
        checkpoint.save_function(field, first.w_current, t=first.current_time,
                                 step=first.current_step)
        again = ScalarTransportSolver(transient_settings(core, V, 2), device=device)
        again.init_solver()
        checkpoint.load_state(state, again)
        same = (np.array_equal(again.w_current.values, first.w_current.values)
                and np.array_equal(again.w_prev.values, first.w_prev.values)
                and again.current_step == first.current_step
                and again.current_time == first.current_time)
        W = core.FunctionSpace(core.UnitCubeMesh(n_other, n_other, n_other), "CG", 1)
        s = transient_settings(core, W, 1)
        s["initial_values"] = {"temperature": field}
        other = ScalarTransportSolver(s, device=device)
        other.init_solver()
        start = other.w_current.values.copy()
        want = interpolate_nonmatching_mesh(first.w_current, W)
        other = run_main(s, device=device)
    err = float(np.abs(start - want.values).max())
    s = transient_settings(core, W, 1)
    s["initial_values"] = {"temperature": want}
    direct = run_main(s, device=device)
    rel = _rel_l2(other.result.values, direct.result.values)
    print(f"[restart] n={n}: state at step {first.current_step}, t = "
          f"{first.current_time:g} taken back bit-equal: {same}; as the initial "
          f"field at n={n_other} by file name: max diff to the interpolated "
          f"field {err:.1e} (tol 1e-12); one step from it on {device} vs the "
          f"step from that field as a Function: rel-L2 {rel:.1e} (tol 1e-12)")
    check(same, "load_state did not restore the saved state")
    check(err <= 1e-12, f"restart field differs from the interpolation: {err}")
    check(np.isfinite(other.result.values).all() and rel <= 1e-12,
          f"the restarted step differs: rel-L2 {rel}")



# -- elasticity, modal analysis, AMG on a scalar case, wave and Maxwell -------

STEEL = {"elastic_modulus": 200e9, "poisson_ratio": 0.3, "density": 7800,
         "thermal_expansion_coefficient": 2e-6}
#: the cantilever of tests/test_linear_elasticity.py at full width:
#: 1,966,080 tets, 349,569 nodes, 1,048,707 dofs
N_CANTILEVER = (320, 32, 32)
#: bound on its AMG-CG iterations at rtol 1e-8.  The reference's hierarchy
#: for this beam is one smoothed level and then a stall (its unknown-based
#: aggregation with six rigid-body columns no longer shrinks the second
#: level), so the coarsest level, 470,868 rows, is "solved" by a degree-12
#: Chebyshev sweep, and the count grows with the mesh: 89 at 19,683 dofs,
#: 144-145 at 139,587, and 348 and 375 in two runs here (so many CG steps
#: amplify the last bits of the products, which differ between processes)
MAX_CG_CANTILEVER = 600


def elasticity_settings(V, bcs, rtol=1e-12, **extra):
    """tests/test_linear_elasticity.py's settings for steel on the vector
    space V (or, with ``mesh=`` in ``extra``, on a mesh)."""
    s = {
        "solver_name": "LinearElasticitySolver", "mesh": None,
        "function_space": V, "boundary_conditions": bcs,
        "temperature_distribution": None, "material": dict(STEEL),
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0,
                                   "time_step": 0.1, "ending_time": 1},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": rtol,
                                  "maximum_iterations": 2000,
                                  "monitor_convergence": False},
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "plotting_interactive": False, "logging_level": 40},
    }
    s.update(extra)
    return s


def cantilever(core, n, degree, L=10.0, b=1.0, h=1.0, Fy=1e6):
    """(V, bcs, Euler-Bernoulli tip deflection) of the beam clamped at x = 0
    with the force Fy spread over the face x = L."""
    mesh = core.BoxMesh(core.Point(0, 0, 0), core.Point(L, b, h), *n)
    V = core.VectorFunctionSpace(mesh, "CG", degree)
    bcs = {
        "fixed": {"boundary": core.AutoSubDomain(lambda x: core.near(x[0], 0.0)),
                  "boundary_id": 1, "type": "Dirichlet",
                  "value": core.Constant((0, 0, 0))},
        "tip": {"boundary": core.AutoSubDomain(lambda x: core.near(x[0], L)),
                "boundary_id": 2, "type": "force", "value": (0.0, Fy, 0.0)},
    }
    return V, bcs, Fy * L**3 / (3 * STEEL["elastic_modulus"] * (b * h**3 / 12.0))


def tip_deflection(V, u, L=10.0):
    X = V.scalar_space.dof_coords
    return float(u.values.reshape(-1, V.vdim)[abs(X[:, 0] - L) < 1e-9, 1].mean())


def profile_amg_cg(op, rhs, amg, iterations=10, cycles=10):
    """Of the AMG-CG solve whose operator, right-hand side and hierarchy are
    given: wall ms a V-cycle (synchronised over ``cycles`` applications) and
    an iteration (``iterations`` CG iterations from zero), and over those
    iterations the device-busy ms and so the idle share (``torch.profiler``,
    as ``profile_vcycle`` reckons it)."""
    import torch

    from fenicssolver_tpu_torch.la import krylov

    def sync():
        if rhs.is_cuda:
            torch.cuda.synchronize()

    amg(rhs)
    sync()
    t0 = time.perf_counter()
    for _ in range(cycles):
        amg(rhs)
    sync()
    cycle_ms = (time.perf_counter() - t0) / cycles * 1e3

    def some_iterations():
        return krylov.cg(op, rhs, M=amg, tol=0.0, maxiter=iterations)

    some_iterations()
    sync()
    t0 = time.perf_counter()
    some_iterations()
    sync()
    iter_ms = (time.perf_counter() - t0) / iterations * 1e3
    prof = _profiled(some_iterations, 1) if rhs.is_cuda else None
    if prof is None:
        dev = "device busy not measured"
    else:
        busy, _, events = prof
        busy, events = busy / iterations, events / iterations
        dev = (f"device busy {busy:.4f} ms an iteration ({events:.0f} device "
               f"events), idle {100 * (1 - busy / iter_ms):.1f}%")
    return cycle_ms, iter_ms, dev


def phase_elasticity(device=None, n=N_CANTILEVER, n_thermal=256, n_p2=(20, 3, 3)):
    """The elasticity path: the cantilever of tests/test_linear_elasticity.py
    through ``main(settings)`` on the default device, vector P1, f64, steel,
    rtol 1e-8, by AMG-CG with the rigid-body near-nullspace; then the
    test's thermal free expansion on ``UnitSquareMesh(n_thermal)`` against
    the exact field, and the vector P2 cantilever (k = 30) on the card
    against the port's CPU solve."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la import krylov
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.ops import assembly, cuda_kernels

    on_card = device is None or str(device).startswith("cuda")
    V, bcs, beam = cantilever(core, n, 1)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with CountCG() as cap:
        solver = run_main(elasticity_settings(V, bcs, rtol=1e-8), device=device)
    wall = time.perf_counter() - t0
    spmv_launches = cuda_kernels.LAUNCHES["csr_spmv"]
    spmv_by_shape = dict(cuda_kernels.SPMV_LAUNCHES_BY_SHAPE)
    dev = solver.device
    if on_card:
        check(dev.type == "cuda", f"the elasticity case ran on {dev}")
    tt = solver.timers.totals
    amg = solver.last_amg
    tip = tip_deflection(V, solver.result)
    vm = solver.von_Mises(solver.result)
    print(f"[elasticity] cantilever {n}: {solver.mesh.num_cells()} tets, "
          f"{V.ndof} dofs on {dev}, {solver.dtype}: main() {wall:.2f} s; form "
          f"{tt['form']:.2f} s, assembly {tt['assembly']:.2f} s (k = "
          f"{V.ndof_el}: {assembly.chunk_cells(V.ndof_el)} cells a chunk), AMG "
          f"set-up {tt['amg_setup']:.2f} s, Krylov {tt['krylov']:.2f} s; "
          f"preconditioner {solver.last_preconditioner}, "
          f"{solver.last_iterations} CG iterations, rel residual "
          f"{solver.last_relres:.3e}"
          + (f"; peak {_peak_gib():.2f} GiB" if on_card else ""))
    for li, lv in enumerate(amg.levels):
        print(f"[elasticity] AMG level {li}: {lv['rows']} rows, {lv['nnz']} "
              f"nnz, set-up {lv['setup_s']:.2f} s: "
              + ", ".join(f"{k} {v:.2f}" for k, v in lv["steps"].items()))
    print(f"[elasticity] AMG coarsest level: {amg.coarse_rows} rows, "
          + ("dense inverse" if amg.coarse_dense is not None
             else "coarsening stalled: degree-12 Chebyshev sweep")
          + ": " + ", ".join(f"{k} {v:.2f}" for k, v in amg.coarse_steps.items())
          + f"; set-up in all {amg.setup_seconds:.2f} s")
    op, rhs, kw = cap.last
    cycle_ms, iter_ms, busy = profile_amg_cg(op, rhs, kw["M"])
    print(f"[elasticity] V-cycle {cycle_ms:.3f} ms, CG iteration {iter_ms:.3f} "
          f"ms (wall, synchronised); {busy}")
    print(f"[elasticity] tip deflection {tip:.6e} m, Euler-Bernoulli "
          f"{beam:.6e} m ({100 * (tip / beam - 1):+.2f}%, tol 8%); von Mises "
          f"max {vm.values.max():.4e} Pa")
    check(solver.last_preconditioner == "amg",
          f"preconditioner {solver.last_preconditioner}, not amg")
    check(kw["M"] is amg, "CG did not run with the AMG hierarchy")
    check(solver.last_iterations <= MAX_CG_CANTILEVER
          and solver.last_relres <= 1e-8,
          f"{solver.last_iterations} CG iterations, rel residual "
          f"{solver.last_relres}")
    check(abs(tip - beam) / beam < 0.08, f"tip deflection {tip} vs {beam}")
    check(np.isfinite(vm.values).all(), "von Mises is not finite")
    coarse = (amg.coarse_rows, amg.coarse_rows)
    coarse_launches = (spmv_by_shape.get(coarse, 0)
                       if amg.coarse_dense is None else 0)
    print(f"[elasticity] csr_spmv launches in main(): {spmv_launches}, "
          f"{coarse_launches} of them on the stalled coarsest A {coarse} "
          f"({coarse_launches / max(solver.last_iterations, 1):.2f} a CG "
          "iteration)")
    if on_card:
        check(spmv_launches > 0, "csr_spmv was not launched by the AMG-CG")
        check(amg.coarse_dense is not None or coarse_launches > 0,
              "csr_spmv was not launched on the stalled coarsest A")

    # F5: the hierarchy applied twice to one vector gives the same bits; a
    # second CG solve with it takes main()'s iterations to the same bits
    z1, z2 = amg(rhs), amg(rhs)
    x2, it2, _ = krylov.cg(op, rhs, **kw)
    same_x = np.array_equal(x2.cpu().numpy(), solver.result.values.ravel())
    print(f"[elasticity] F5: V-cycle twice bit-equal {torch.equal(z1, z2)}; "
          f"a second CG solve {it2} iterations (main() {solver.last_iterations}"
          f"), solution bit-equal {same_x}")
    check(torch.equal(z1, z2), "the AMG V-cycle applied twice differs")
    check(it2 == solver.last_iterations and same_x,
          f"a second AMG-CG solve took {it2} iterations against "
          f"{solver.last_iterations}, bit-equal {same_x}")
    del z1, z2, x2
    spmv = phase_csr_spmv(amg) if on_card else None
    # the serial reference of [lattice-elasticity]: the same hierarchy to 1e-10
    t0 = time.perf_counter()
    x10, it10, res10 = krylov.cg(op, rhs, **dict(kw, tol=1e-10))
    _sync(device)
    serial = {"V": V, "bcs": bcs, "x": x10.cpu().numpy(), "iterations": it10,
              "seconds": time.perf_counter() - t0, "relres": res10,
              "spmv": spmv, "spmv_launches": spmv_launches,
              "coarse_launches": coarse_launches}
    print(f"[elasticity] AMG-CG to 1e-10: {it10} iterations, "
          f"{serial['seconds']:.2f} s, rel res {res10:.3e}")
    del solver, amg, cap, op, rhs, kw, x10

    # thermal stress: sliding supports, a uniform temperature, no load
    mesh = core.UnitSquareMesh(n_thermal, n_thermal)
    V = core.VectorFunctionSpace(mesh, "CG", 1)
    bcs = {
        "left": {"boundary": core.AutoSubDomain(lambda x: core.near(x[0], 0.0)),
                 "boundary_id": 1, "type": "Dirichlet",
                 "value": (core.Constant(0), None)},
        "bottom": {"boundary": core.AutoSubDomain(lambda x: core.near(x[1], 0.0)),
                   "boundary_id": 2, "type": "Dirichlet",
                   "value": (None, core.Constant(0))},
    }
    s = elasticity_settings(V, bcs, rtol=1e-13)
    s["temperature_distribution"] = core.Expression("293 + 50", degree=1)
    s["solver_settings"]["solver_parameters"]["preconditioner"] = "amg"
    solver = run_main(s, device=device)
    E, nu, alpha, dT = (STEEL["elastic_modulus"], STEEL["poisson_ratio"],
                        STEEL["thermal_expansion_coefficient"], 50.0)
    mu, lmbda = E / (2 * (1 + nu)), E * nu / ((1 + nu) * (1 - 2 * nu))
    e = E * alpha * dT / ((1 - 2 * nu) * 2 * (mu + lmbda))
    err = _rel_l2(solver.result.values.reshape(-1, 2),
                  e * V.scalar_space.dof_coords)
    print(f"[elasticity] thermal free expansion {n_thermal} x {n_thermal}: "
          f"{V.ndof} dofs on {solver.device}, {solver.last_preconditioner}-"
          f"{solver.last_krylov} {solver.last_iterations} iterations; rel-L2 vs "
          f"the exact expansion {err:.3e} (tol 1e-9)")
    check(solver.last_preconditioner == "amg",
          f"thermal case preconditioned by {solver.last_preconditioner}")
    check(err < 1e-9, f"thermal expansion rel-L2 {err}")

    # vector P2 (k = 30) on the card against the CPU
    res = {}
    for where in (device, "cpu"):
        V, bcs, beam = cantilever(core, n_p2, 2)
        sol = run_main(elasticity_settings(V, bcs), device=where)
        res[where] = (sol.result.values.copy(), sol.last_iterations,
                      sol.last_preconditioner, tip_deflection(V, sol.result),
                      sol.device)
    (ug, ig, pg, tg, dg), (uc, ic, pc, _, _) = res[device], res["cpu"]
    rel = _rel_l2(ug, uc)
    print(f"[elasticity] P2 cantilever {n_p2}: {V.ndof} dofs, k = {V.ndof_el} "
          f"({assembly.chunk_cells(V.ndof_el)} cells a chunk): {dg} {pg}-CG "
          f"{ig} iterations, cpu {ic}; rel-L2 {rel:.3e} (tol 1e-8); tip "
          f"{100 * (tg / beam - 1):+.2f}% from Euler-Bernoulli")
    check(pg == "amg" and pc == "amg", f"P2 preconditioners {pg}, {pc}")
    check(rel <= 1e-8, f"P2 card vs CPU rel-L2 {rel}")
    check(ig == ic, f"P2 iterations {ig} on the card, {ic} on the CPU")
    check(abs(tg - beam) / beam < 0.08, f"P2 tip deflection {tg} vs {beam}")
    return serial


def spmv_bytes(n_rows, n_cols, nnz, itemsize):
    """csr_spmv on a vector: the values and column indices (int32) and the
    row pointer read once, x read once, y written once."""
    return nnz * (itemsize + 4) + (n_rows + 1) * 4 + (n_rows + n_cols) * itemsize


def spmv_group_text(group):
    """A group size of ``csr_spmv`` and its variant, in words."""
    return (f"{group} threads a row" + (" (a block)" if group > 32 else ""))


def phase_csr_spmv(amg):
    """``csr_spmv`` against its plain version (PyTorch's CSR product, i.e.
    cuSPARSE, the library call) on the AMG hierarchy of the elasticity
    path: the level-0 operator on a vector and on a block of 6 columns (as
    LOBPCG passes), R, P and the stalled coarsest level's operator, each at
    every group size of ``SPMV_GROUPS`` (the plan's variants), twice
    bit-equal; timed on the level-0 operator and on the coarsest one with a
    vector (the latter returned under ``"coarsest"``)."""
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels

    lv = amg.levels[0]
    A, p = lv["A"], lv["A"].pattern
    gen = torch.Generator(device=A.data.device).manual_seed(12)

    def operands(ip, ix, data, shape, cols=None):
        x = torch.randn((shape[1],) if cols is None else (shape[1], cols),
                        generator=gen, dtype=data.dtype, device=data.device)
        return (ip, ix, data, x, shape)

    cases = {"A": operands(p.indptr, p.indices, A.data, A.shape),
             "A, 6 columns": operands(p.indptr, p.indices, A.data, A.shape, 6)}
    for name in ("R", "P"):
        M = lv[name]
        cases[name] = operands(M.indptr, M.indices, M.data, M.shape)
    coarse = getattr(amg, "_coarse_cheb", None)
    if coarse is not None:  # the stalled level's Chebyshev "solve"
        C = coarse["A"]
        cases["coarsest A"] = operands(C.pattern.indptr, C.pattern.indices,
                                       C.data, C.shape)
    for name, args in cases.items():
        times = []
        for group in cuda_kernels.SPMV_GROUPS:
            err, _ = _agree("csr-spmv", f"{name}, {group} threads",
                            lambda: cuda_kernels.csr_spmv(*args, group=group),
                            lambda: cuda_kernels.csr_spmv_reference(*args),
                            TOL["float64"])
            y1 = cuda_kernels.csr_spmv(*args, group=group)
            y2 = cuda_kernels.csr_spmv(*args, group=group)
            check(torch.equal(y1, y2),
                  f"csr_spmv {name} with {group} threads twice differs")
            ms = time_ms(lambda: cuda_kernels.csr_spmv(*args, group=group),
                         flush=True)
            times.append(f"{group} {ms:.4f}")
        lib = time_ms(lambda: cuda_kernels.csr_spmv_reference(*args),
                      flush=True)
        (rows, cols), nnz = args[4], args[2].numel()
        m = 1 if args[3].dim() == 1 else args[3].shape[1]
        print(f"[csr-spmv] {name} {tuple(args[4])}, {nnz} nnz "
              f"({nnz / rows:.1f} a row): max abs err {err:.2e} against "
              f"cuSPARSE, each twice bit-equal; ms flushed by threads a row: "
              + ", ".join(times) + f"; cuSPARSE {lib:.4f}; the plan: "
              + spmv_group_text(cuda_kernels.spmv_plan(rows, cols, nnz, m)))

    def timed(name, what):
        args = cases[name]
        (n_rows, n_cols), nnz = args[4], args[2].numel()
        group = cuda_kernels.spmv_plan(n_rows, n_cols, nnz)
        return _compare(
            "csr-spmv", f"{what}: {n_rows} rows, {nnz} nnz, f64, "
            + spmv_group_text(group),
            lambda: cuda_kernels.csr_spmv(*args),
            lambda: cuda_kernels.csr_spmv_reference(*args),
            spmv_bytes(n_rows, n_cols, nnz, 8), 2 * nnz, "float64",
            TOL["float64"],
            library=lambda: cuda_kernels.csr_spmv_reference(*args),
            library_case="torch.sparse_csr_tensor @ x (cuSPARSE), which is "
                         "the plain version")

    out = timed("A", "level 0 A")
    if "coarsest A" in cases:
        out["coarsest"] = timed("coarsest A", "the stalled coarsest A")
    return out


#: the cantilever's mesh for the set-up repeat check: 139,587 dofs, a set-up
#: of seconds
N_SETUP_REPEAT = (160, 16, 16)


def cantilever_system(device=None, n=N_CANTILEVER):
    """The elasticity cantilever's assembled system at ``n``: (the host CSR
    of the constrained matrix, the free mask, the rigid-body modes, the
    constrained operator and right-hand side on the device)."""
    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la import amg as amg_mod
    from fenicssolver_tpu_torch.ops import assembly
    from fenicssolver_tpu_torch.solvers.linear_elasticity import (
        LinearElasticitySolver,
    )

    V, bcs, _ = cantilever(core, n, 1)
    s = LinearElasticitySolver(elasticity_settings(V, bcs, rtol=1e-8),
                               device=device)
    s.init_solver()
    s.current_step = 0
    form, dd = s.generate_form(0, None, None, s.w_current, s.w_prev)
    A, b = assembly.assemble_linear_system(form)
    Ah = assembly.constrain_csr(A, dd.free_mask).to_host()
    free = dd.free_mask.cpu().numpy() > 0.5
    B = amg_mod.rigid_body_modes(V.scalar_space.dof_coords, 3)
    op = assembly.constrained_operator(A.matvec, dd.free_mask)
    rhs = assembly.constrained_rhs(A.matvec, b, dd.free_mask, dd.u_bc)
    return Ah, free, B, op, rhs, s.device


def _arrays(obj):
    """The arrays of a set-up step's result, flattened: tensors and numpy
    arrays as host arrays, CSR tuples and tuples element by element,
    numbers as 0-d arrays."""
    import numpy as np
    import torch

    if torch.is_tensor(obj):
        return [obj.detach().cpu().numpy()]
    if isinstance(obj, (tuple, list)):
        return [a for o in obj for a in _arrays(o)]
    return [np.asarray(obj)]


def digest(arrays):
    """The first 16 hex digits of the sha256 of the arrays' bytes."""
    import hashlib

    import numpy as np

    return hashlib.sha256(b"".join(
        np.ascontiguousarray(a).tobytes() for a in arrays)).hexdigest()[:16]


class RecordSetup:
    """While active, records in order the ``digest`` of what each step of
    the AMG set-up returns, as ``records`` of (level, step, digest): on the
    host the strength graph, the aggregates, the tentative prolongator and
    D^-1 A (``sparse_algebra.sp_diag_scale``); on the device
    ``la/amg._power`` (the D^-1 A estimate ``lam`` or an l1 estimate
    ``lam1``, also kept as ``powers``) and ``sparse_algebra``'s
    ``dev_matmat``, ``dev_add`` and ``dev_transpose``.  The level is counted
    by the strength graphs (a stalled attempt is the coarsest level's)."""

    HOST = ("_strength_graph", "_aggregate", "_tentative_prolongator")
    DEVICE = ("dev_matmat", "dev_add", "dev_transpose")

    def __enter__(self):
        from fenicssolver_tpu_torch.la import amg as amg_mod
        from fenicssolver_tpu_torch.la import sparse_algebra as sa

        self.records, self.powers, self.saved = [], [], []
        self.level = -1

        def record(owner, name, label):
            fn = getattr(owner, name)

            def run(*args, **kw):
                out = fn(*args, **kw)
                if name == "_strength_graph":
                    self.level += 1
                step = label
                if name == "_power":
                    step += ": lam" if kw.get("final", True) else ": lam1"
                    self.powers.append((self.level, step, out))
                self.records.append((self.level, step, digest(_arrays(out))))
                return out

            self.saved.append((owner, name, fn))
            setattr(owner, name, run)

        for name in self.HOST + ("_power",):
            record(amg_mod, name, name.strip("_"))
        record(sa, "sp_diag_scale", "D^-1 A")
        for name in self.DEVICE:
            record(sa, name, name)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def first_difference(rec1, rec2):
    """The first (level, name) whose digests differ between two lists of
    (level, name, digest), or None."""
    for r1, r2 in zip(rec1, rec2):
        if list(r1) != list(r2):
            return tuple(r1[:2])
    if len(rec1) != len(rec2):
        return "length", (len(rec1), len(rec2))
    return None


def hierarchy_digests(M):
    """The ``digest`` of every array of an ``AMGPreconditioner``'s
    hierarchy, by level: [(level, name, digest)]."""
    import numpy as np

    out = []
    for li, lv in enumerate(M.levels):
        A = lv["A"]
        out += [(li, "A", _arrays((A.pattern.indptr, A.pattern.indices,
                                    A.data))),
                (li, "l1", _arrays(lv["l1"])),
                (li, "lam1", [np.float64(lv["lam1"])])]
        for name in ("P", "R"):
            T = lv[name]
            out.append((li, name, _arrays((T.indptr, T.indices, T.data))))
    L = len(M.levels)
    if M.coarse_dense is not None:
        out.append((L, "coarse pinv", _arrays(M.coarse_dense)))
    else:
        C = M._coarse_cheb
        out += [(L, "coarse A", _arrays(C["A"].data)),
                (L, "coarse l1", _arrays(C["l1"])),
                (L, "coarse lam1", [np.float64(C["lam1"])])]
    return [(li, name, digest(a)) for li, name, a in out]


def recorded_setup(system):
    """One AMG set-up of the cantilever ``system`` (``cantilever_system``)
    under ``RecordSetup``, and an AMG-CG solve to 1e-8 with it: a dict of
    the set-up's records and power estimates, the hierarchy's digests, the
    iterations, the solution's digest, the seconds of each, the level sizes
    and the digest of the inputs (A, B, the right-hand side)."""
    from fenicssolver_tpu_torch.la import krylov
    from fenicssolver_tpu_torch.la.amg import AMGPreconditioner

    Ah, free, B, op, rhs, dev = system
    t0 = time.perf_counter()
    with RecordSetup() as rec:
        M = AMGPreconditioner(Ah, nullspace=B, free_mask=free, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    x, it, res = krylov.cg(op, rhs, M=M, tol=1e-8, maxiter=MAX_CG_CANTILEVER)
    _sync(dev)
    return dict(records=rec.records, powers=rec.powers,
                arrays=hierarchy_digests(M), iterations=it, relres=res,
                x=digest(_arrays(x)), setup_s=t1 - t0,
                cg_s=time.perf_counter() - t1,
                rows=[lv["rows"] for lv in M.levels] + [M.coarse_rows],
                inputs=digest((Ah.indptr, Ah.indices, Ah.data, B,
                               rhs.cpu().numpy())))


def setup_digest_run(n=N_SETUP_REPEAT):
    """Prints, as one JSON line, ``recorded_setup`` of the cantilever at
    ``n`` without its timings: the other process of
    ``phase_amg_setup_repeat``."""
    sys.path.insert(0, HERE)
    b = recorded_setup(cantilever_system(None, tuple(n)))
    print(json.dumps({k: b[k] for k in ("inputs", "records", "arrays", "x",
                                        "iterations")}))


def phase_amg_setup_repeat(device=None, n=N_SETUP_REPEAT):
    """F5's set-up part: the cantilever's AMG set-up at ``n`` in this
    process and in a second one at the same time on the same card
    (``setup_digest_run``) gives the same bits in every step of the set-up
    (``RecordSetup``) and in every array of every level (A, l1, lam1, P, R,
    the coarse solve), and the two AMG-CG solves, one with each hierarchy,
    take the same count to the same bits.  On a difference it prints the
    first level and array (or set-up step) that differ and fails.  Prints
    every step's digest, to compare across machines."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         f"chip_smoke.setup_digest_run({tuple(n)!r})"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ours = recorded_setup(cantilever_system(device, n))
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
    print(f"[amg-setup-repeat] cantilever {n}: levels {ours['rows']}; set-up "
          f"{ours['setup_s']:.2f} s, {len(ours['records'])} set-up steps "
          f"recorded; power estimates {ours['powers']}; AMG-CG "
          f"{ours['iterations']} iterations ({ours['cg_s']:.2f} s)")
    print(f"[amg-setup-repeat] digests (to compare across machines): inputs "
          f"{ours['inputs']}, steps " + " ".join(
              f"{lvl}:{name}:{d}" for lvl, name, d in ours["records"]))
    check(proc.returncode == 0,
          f"the second process failed: {stderr[-2000:]}")
    other = json.loads(stdout.strip().splitlines()[-1])
    step = first_difference(ours["records"], other["records"])
    arrays = first_difference(ours["arrays"], other["arrays"])
    print(f"[amg-setup-repeat] the set-up in another process at the same "
          f"time ({time.perf_counter() - t0:.1f} s in all): inputs "
          f"{'equal' if other['inputs'] == ours['inputs'] else 'DIFFER'}; "
          f"first set-up step that differs: {step or 'none'}; first "
          f"hierarchy array that differs: {arrays or 'none'}; AMG-CG "
          f"{other['iterations']} iterations, solutions bit-equal "
          f"{other['x'] == ours['x']}")
    check(other["inputs"] == ours["inputs"] and step is None
          and arrays is None,
          f"two AMG set-ups differ: inputs {other['inputs']} / "
          f"{ours['inputs']}, first step {step}, first array {arrays} "
          "(level, name)")
    check(other["iterations"] == ours["iterations"]
          and other["x"] == ours["x"],
          f"AMG-CG from two set-ups: {other['iterations']} and "
          f"{ours['iterations']} iterations, bit-equal "
          f"{other['x'] == ours['x']}")
    return {"iterations": ours["iterations"], "records": ours["records"]}


def measure_amg_setup_repeat(n=N_CANTILEVER):
    """``phase_amg_setup_repeat`` at ``n`` (the full cantilever by default:
    two set-ups of ~45 s at the same time), then one more set-up whose power iterations
    multiply by PyTorch's CSR product (cuSPARSE on the card) in place of
    ``csr_spmv``: the first step where it differs, and its AMG-CG count.
    Not part of ``main()``."""
    from fenicssolver_tpu_torch.la import amg as amg_mod
    from fenicssolver_tpu_torch.ops import cuda_kernels

    from fenicssolver_tpu_torch.la import krylov

    ours = phase_amg_setup_repeat(n=n)
    Ah, free, B, op, rhs, dev = cantilever_system(None, n)
    fixed = amg_mod.rect_matvec

    def library(M, x):
        return cuda_kernels.csr_spmv_reference(M.indptr, M.indices, M.data,
                                               x, M.shape)

    # during the set-up only _power calls rect_matvec (the V-cycle's R and
    # P products come after it)
    amg_mod.rect_matvec = library
    try:
        with RecordSetup() as rec:
            M = amg_mod.AMGPreconditioner(Ah, nullspace=B, free_mask=free,
                                          device=dev)
    finally:
        amg_mod.rect_matvec = fixed
    _, it, _ = krylov.cg(op, rhs, M=M, tol=1e-8, maxiter=MAX_CG_CANTILEVER)
    print(f"[amg-setup-repeat] the power iterations by PyTorch's CSR product: "
          f"first set-up step that differs from csr_spmv's "
          f"{first_difference(ours['records'], rec.records) or 'none'}; "
          f"power estimates {rec.powers}; AMG-CG {it} iterations (csr_spmv's "
          f"{ours['iterations']})")


def phase_modal(device=None, n=(96, 11, 11), n_modes=6):
    """``solve_modal`` of a clamped P1 beam (5 x 0.5 x 0.5, steel): LOBPCG
    with the AMG V-cycle on the device against scipy's shift-invert
    ``eigsh`` on the same K and M (host)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la.sparse_algebra import sp_submatrix
    from fenicssolver_tpu_torch.solvers.linear_elasticity import (
        LinearElasticitySolver,
    )

    mesh = core.BoxMesh(core.Point(0, 0, 0), core.Point(5.0, 0.5, 0.5), *n)
    V = core.VectorFunctionSpace(mesh, "CG", 1)
    bcs = {"fixed": {
        "boundary": core.AutoSubDomain(lambda x: core.near(x[0], 0.0)),
        "boundary_id": 1, "type": "Dirichlet", "value": core.Constant((0, 0, 0))}}
    solver = LinearElasticitySolver(elasticity_settings(V, bcs), device=device)
    t0 = time.perf_counter()
    freqs, modes = solver.solve_modal(n_modes)
    wall = time.perf_counter() - t0
    K, M, free = solver.modal_matrices()
    t0 = time.perf_counter()
    Kf, Mf = (sp_submatrix(m.to_host(), free) for m in (K, M))
    Ks, Ms = (sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape).tocsc()
              for m in (Kf, Mf))
    vals = np.sort(spl.eigsh(Ks, k=n_modes, M=Ms, sigma=0, which="LM")[0])
    host = time.perf_counter() - t0
    ref = np.sqrt(vals) / (2 * np.pi)
    rel = float(np.abs(freqs / ref - 1).max())
    print(f"[modal] clamped beam {n}: {V.ndof} dofs on {solver.device}; "
          f"backend {solver.last_modal_backend}, "
          f"{getattr(solver, 'last_modal_iterations', None)} LOBPCG iterations, "
          f"solve_modal {wall:.2f} s (assembly and AMG set-up included); "
          f"scipy eigsh on the host {host:.2f} s; f = "
          + ", ".join(f"{f:.3f}" for f in freqs)
          + f" Hz; max relative difference {rel:.3e} (tol 1e-4)")
    check(solver.last_modal_backend == "lobpcg",
          f"the modes came from {solver.last_modal_backend}, not LOBPCG")
    check(rel <= 1e-4, f"modal frequencies differ by {rel}")
    check(all(np.isfinite(m.values).all() for m in modes), "a mode is not finite")


def phase_amg_scalar(device="cuda", n=32):
    """The steady heat case of ``phase_body_source`` preconditioned by AMG
    against the same case preconditioned by GMG."""
    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    res = {}
    for prec in ("amg", "gmg"):
        V = core.FunctionSpace(core.UnitCubeMesh(n, n, n), "CG", 1)
        s = heat_settings(core, V, body_source=1000.0)
        s["solver_settings"]["solver_parameters"]["preconditioner"] = prec
        sol = ScalarTransportSolver(s, device=device)
        res[prec] = (sol.solve().values.copy(), sol.last_iterations,
                     sol.last_preconditioner)
    (Ta, ia, pa), (Tg, ig, pg) = res["amg"], res["gmg"]
    rel = _rel_l2(Ta, Tg)
    print(f"[amg-scalar] heat n={n} with a body source on {device}: amg-CG {ia} "
          f"iterations, gmg-CG {ig} iterations; rel-L2 {rel:.3e} (tol 1e-8)")
    check(pa == "amg" and pg == "gmg", f"preconditioners ran: {pa}, {pg}")
    check(rel <= 1e-8, f"amg vs gmg rel-L2 {rel}")


def _on_plane(core, axis, value):
    """The sub-domain of the points with coordinate ``axis`` at ``value``."""
    return core.AutoSubDomain(lambda x: core.near(x[axis], value))


def wave_settings(core, n, dt, t_end, c=2.0):
    """tests/test_wave.py's settings on ``UnitSquareMesh(n)``, P2: the (1,1)
    mode at rest, u = 0 on the four edges.  Returns (settings, mode)."""
    import numpy as np

    Q = core.FunctionSpace(core.UnitSquareMesh(n, n), "CG", 2)
    X = Q.dof_coords
    mode = np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])
    bcs = {
        f"b{i}": {"boundary": _on_plane(core, a, w), "boundary_id": i + 1,
                  "values": [{"variable": "amplitude", "type": "Dirichlet",
                              "value": 0.0}]}
        for i, (a, w) in enumerate([(0, 0.0), (0, 1.0), (1, 0.0), (1, 1.0)])
    }
    return {
        "solver_name": "WavePropagationSolver", "function_space": Q,
        "boundary_conditions": bcs, "scalar_name": "amplitude",
        "initial_values": {"amplitude": mode, "amplitude_velocity": 0.0},
        "material": {"wave_speed": c},
        "solver_settings": {
            "transient_settings": {"transient": True, "starting_time": 0.0,
                                   "time_step": dt, "ending_time": t_end},
            "reference_values": {},
            "solver_parameters": {"relative_tolerance": 1e-12,
                                  "maximum_iterations": 500},
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "logging_level": 40},
    }, mode


def phase_wave(device=None, n=255, n_test=16, dt=0.0025, t_end=0.2):
    """tests/test_wave.py's standing mode u = cos(w t) sin(pi x) sin(pi y),
    P2, Newmark, with the test's time step and end time, through
    ``main(settings)``: at the test's own size to the test's own bounds
    (error under 2e-3, final energy within 5e-3 of c^2 pi^2 / 4), and on
    ``UnitSquareMesh(n)``.  The start-up value u^{-1} = u0 - dt v0 +
    dt^2/2 a0 leaves the Dirichlet dofs of a0 free, as the reference does:
    a disturbance of order dt^2 / h that the test's bounds cover only up to
    n ~ 90 (the reference reads 1.05e-3 at n = 64).  At n the run is
    therefore held to what Newmark guarantees whatever the start: the
    discrete energy after the first step is the energy after the last, to
    1e-9; the distance from the exact mode is printed and bounded by
    2e-2."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.solvers.wave import WavePropagationSolver

    c = 2.0
    E0 = c * c * np.pi**2 / 4.0
    energies = []
    inner = WavePropagationSolver.solve_current_step

    def step_and_energy(self):
        inner(self)
        if self.current_step == 0 or self.current_time + 1.5 * dt >= t_end:
            energies.append(self.energy())

    for size in (n_test, n):
        s, mode = wave_settings(core, size, dt, t_end, c)
        del energies[:]
        WavePropagationSolver.solve_current_step = step_and_energy
        try:
            t0 = time.perf_counter()
            solver = run_main(s, device=device)
            wall = time.perf_counter() - t0
        finally:
            WavePropagationSolver.solve_current_step = inner
        ref = np.cos(c * np.pi * np.sqrt(2.0) * t_end) * mode
        err = float(np.linalg.norm(solver.result.values - ref)
                    / np.linalg.norm(mode))
        E_first, E_end = energies[0], energies[-1]
        drift = abs(E_end / E_first - 1)
        print(f"[wave] standing mode {size} x {size} P2: "
              f"{solver.function_space.ndof} dofs on {solver.device}, "
              f"{solver.steps_taken} Newmark steps of {dt} in {wall:.2f} s, last "
              f"step {solver.last_krylov} {solver.last_iterations} iterations; "
              f"error {err:.3e}; energy {E_end:.6f} after the last step, "
              f"{E_first:.6f} after the first (drift {drift:.2e}, tol 1e-9), "
              f"c^2 pi^2/4 = {E0:.6f} ({abs(E_end / E0 - 1):.2e})")
        check(drift <= 1e-9, f"the energy drifted by {drift}")
        if size == n_test:
            check(err < 2e-3, f"standing mode error {err} at the test's size")
            check(abs(E_end / E0 - 1) <= 5e-3, f"energy {E_end} vs {E0}")
        else:
            check(err < 2e-2, f"standing mode error {err}")


def phase_maxwell(device=None, n=120):
    """tests/test_maxwell.py's magnetostatic slab (a current sheet in
    0.4 < x < 0.6) at P2 against its exact piecewise-quadratic A_z."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.solvers.maxwell import (
        magnetic_permeability_in_vacuum as MU0,
    )

    J0, X1, X2 = 2.0e6, 0.4, 0.6
    Q = core.FunctionSpace(core.UnitSquareMesh(n, n), "CG", 2)
    bcs = {
        name: {"boundary": _on_plane(core, 0, w), "boundary_id": i + 1,
               "values": [{"variable": "magnetic_potential",
                           "type": "Dirichlet", "value": 0.0}]}
        for i, (name, w) in enumerate([("left", 0.0), ("right", 1.0)])
    }
    s = {
        "solver_name": "MaxwellEMSolver", "function_space": Q,
        "boundary_conditions": bcs, "scalar_name": "magnetic_potential",
        "body_source": core.Expression("J0*(x[0] > x1)*(x[0] < x2)", degree=0,
                                       J0=J0, x1=X1, x2=X2),
        "initial_values": {"magnetic_potential": 0.0},
        "material": {"relative_magnetic_permeability": 1.0},
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0.0,
                                   "time_step": 0.002, "ending_time": 0.02},
            "reference_values": {},
            "solver_parameters": {"relative_tolerance": 1e-13,
                                  "maximum_iterations": 20000},
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "logging_level": 40},
    }
    solver = run_main(s, device=device)
    nu, w = 1.0 / MU0, X2 - X1
    A1 = J0 * w / (2.0 * nu)  # |A'| outside the strip
    x = Q.dof_coords[:, 0]
    ref = np.where(x <= X1, A1 * x, np.where(
        x >= X2, A1 * (1.0 - x),
        A1 * X1 + A1 * (x - X1) - (J0 / (2.0 * nu)) * (x - X1) ** 2))
    err = _rel_l2(solver.result.values, ref)
    B, _ = solver.magnetic_flux_density_qp(solver.result)
    Bmax, Bref = float(B.abs().max()), MU0 * J0 * w / 2.0
    print(f"[maxwell] magnetostatic slab {n} x {n} P2: {Q.ndof} dofs on "
          f"{solver.device}, {solver.last_krylov} {solver.last_iterations} "
          f"iterations; rel-L2 vs the exact A_z {err:.3e} (tol 1e-8); max|B| "
          f"{Bmax:.6e} vs mu0 J0 w / 2 = {Bref:.6e} T")
    check(err < 1e-8, f"slab rel-L2 {err}")
    check(abs(Bmax / Bref - 1) <= 1e-6, f"max|B| {Bmax} vs {Bref}")


def phase_elasticity_cli(on="cuda"):
    """An elasticity JSON case on ``data/mesh.xml`` (clamped on boundary 1,
    pulled along z on boundary 2, vector P2), written into a temporary
    directory, through ``python -m fenicssolver_tpu_torch`` with
    ``FST_DEVICE`` unset (``on="cpu"``: set to ``cpu``)."""
    import tempfile

    env = {k: v for k, v in os.environ.items() if k != "FST_DEVICE"}
    env["PYTHONPATH"] = HERE
    if on == "cpu":
        env["FST_DEVICE"] = "cpu"
    settings = {
        "solver_name": "LinearElasticitySolver",
        "mesh": os.path.join(HERE, "data", "mesh.xml"),
        "fe_degree": 2, "fe_family": "CG", "periodic_boundary": None,
        "material": dict(STEEL),
        "boundary_conditions": {
            "fixed": {"boundary_id": 1, "type": "Dirichlet", "value": [0, 0, 0]},
            "pulled": {"boundary_id": 2, "type": "stress",
                       "value": [0.0, 0.0, 1e6]},
        },
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0,
                                   "time_step": 0.1, "ending_time": 1},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 2000,
                                  "monitor_convergence": False},
        },
        "report_settings": {"plotting_freq": 0, "saving_freq": 1,
                            "plotting_interactive": False, "logging_level": 40,
                            "result_filename": "u.pvd"},
    }
    with tempfile.TemporaryDirectory() as tmp:
        case = os.path.join(tmp, "elasticity.json")
        with open(case, "w") as f:
            json.dump(settings, f)
        proc = subprocess.run(
            [sys.executable, "-m", "fenicssolver_tpu_torch", case],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        u = (_pvd_last_values(os.path.join(tmp, "u.pvd"), "f")
             if proc.returncode == 0 else None)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"[elasticity-cli] FST_DEVICE {'unset' if on != 'cpu' else 'cpu'}: rc "
          f"{proc.returncode}; {line}")
    check(proc.returncode == 0, f"elasticity CLI: {proc.stderr[-2000:]}")
    check("LinearElasticitySolver" in line and f" on {on}" in line,
          f"the elasticity CLI case did not run on {on}")
    uz = u.reshape(-1, 3)[:, 2]
    check(bool((abs(u) < 1).all()) and uz.max() > 0,
          "the saved displacement is not a pull along z")


# -- nonlinear solids, elastodynamics and the adjoint ------------------------

RUBBER = {"elastic_modulus": 10, "poisson_ratio": 0.3, "density": 800,
          "thermal_expansion_coefficient": 2e-6}
QUIET = {"plotting_freq": 0, "saving_freq": 0, "plotting_interactive": False,
         "logging_level": 40}
#: the hyperelastic twist at the reference's own size: 36,864 tets,
#: 7,225 nodes, 21,675 dofs (Jacobi-GMRES(80) Newton updates; the JAX
#: package's example runs it at 6 x 4 x 4)
N_TWIST = (24, 16, 16)
#: the contact block: 64 x 64 (8,450 dofs, dense LU).  Jacobi-GMRES(80)
#: takes 1,086-1,349 iterations a Newton update at 32 x 32 and 4,106-5,423
#: at 64 x 64 (CPU rehearsal), so ~16,000-22,000 at 128 x 128: the
#: 200-restart cap of the Newton updates.  The ball stays at 24 x 24: on
#: finer meshes full Newton steps against it invert elements (NaN at 32).
N_CONTACT, N_BALL = 64, 24
#: the J2 bar: 82,944 tets, 46,875 dofs (32^3, 107,811 dofs, took ~79 s
#: of the script's time; cut to make room for the bench paths); the
#: unloading step is taken in N_PLASTIC // 4 increments (one increment
#: inverts the return map's branch in the layer of cells next to the pulled
#: face and Newton cycles there, from 8 x 8 x 8 on; the unloaded state is
#: elastic, so the same)
N_PLASTIC = 24
#: the 2-D beam of examples/test_large_deformation.py: 128 x 16, mixed P1,
#: 10,965 dofs (dense LU)
N_BEAM = 128
#: the elastodynamics bar: 245,760 tets, 139,587 dofs; the time loop it is
#: held to runs at 80 x 8 x 8 (19,683 dofs), where its AMG set-up a step is
#: ~1 s and not ~25 s
N_DYNAMICS, N_DYNAMICS_LOOP = (160, 16, 16), (80, 8, 8)
#: Jacobi-PCG's cap a step there (the fast path's default, 2,000, is below
#: what the 139,587-dof bar needs to reach 1e-10)
DYNAMICS_MAXITER = 20000
#: the adjoint gradient check: UnitSquareMesh(256), 131,072 cells, 66,049 dofs
N_ADJOINT = 256


def _on_card(device):
    return device is None or str(device).startswith("cuda")


def _reset_peak(device):
    import torch

    if _on_card(device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_text(device):
    return f"; peak {_peak_gib():.2f} GiB" if _on_card(device) else ""


def _newton_lines(tag, solver, what=""):
    """One line per Newton step of the solver's last solve: the seconds of
    its Jacobian, linear solve and residual, and the solve's iterations."""
    for k, st in enumerate(solver.last_newton, start=1):
        rel = "" if st["relres"] is None else f", rel res {st['relres']:.2e}"
        print(f"[{tag}] {what}Newton step {k}: Jacobian {st['jacobian_s']:.3f} "
              f"s, solve {st['solve_s']:.3f} s ({st['iterations']}{rel}), "
              f"residual {st.get('residual_s', float('nan')):.3f} s")


TWIST = ("scale*(y0 + (x[1] - y0)*cos(theta) - (x[2] - z0)*sin(theta) - x[1])",
         "scale*(z0 + (x[1] - y0)*sin(theta) + (x[2] - z0)*cos(theta) - x[2])")


def twist_settings(core, n):
    """The twist of examples/test_nonlinear_elasticity.py (the reference's
    dolfin hyperelasticity demo) on ``UnitCubeMesh(*n)``: x = 0 clamped,
    x = 1 rotated by pi/3 about its centre line, a body force and the
    example's surface load.  Newton starts from the twist scaled by x: from
    the Dirichlet data alone (interior at rest) the first update inverts
    cells next to x = 1 at 24 x 16 x 16 (NaN at Newton step 1)."""
    import numpy as np

    def twist(prefix):
        return core.Expression(("0.0",) + tuple(prefix + t for t in TWIST),
                               scale=0.5, y0=0.5, z0=0.5, theta=np.pi / 3,
                               degree=2)

    return {
        "solver_name": "NonlinearElasticitySolver",
        "mesh": core.UnitCubeMesh(*n), "fe_degree": 1,
        "boundary_conditions": {
            "left": {"boundary": _on_plane(core, 0, 0.0), "boundary_id": 1,
                     "type": "Dirichlet", "value": core.Constant((0.0, 0.0, 0.0))},
            "right": {"boundary": _on_plane(core, 0, 1.0), "boundary_id": 2,
                      "type": "Dirichlet", "value": twist("")},
        },
        "initial_values": {"displacement": twist("x[0]*")},
        "body_source": core.Constant((0.0, -0.5, 0.0)),
        "surface_source": {"value": core.Constant(0.1),
                           "direction": core.Constant((1, 0.0, 0.0))},
        "material": dict(RUBBER),
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0,
                                   "time_step": 0.1, "ending_time": 1},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 50,
                                  "monitor_convergence": False},
        },
        "report_settings": dict(QUIET),
    }


def _twist_errors(solver):
    """(max |u| on x = 0, max distance from the rotation on x = 1)."""
    import numpy as np

    V = solver.function_space
    U = solver.result.values.reshape(-1, 3)
    X = V.scalar_space.dof_coords
    left, right = np.abs(X[:, 0]) < 1e-12, np.abs(X[:, 0] - 1.0) < 1e-12
    th, y, z = np.pi / 3, X[right, 1], X[right, 2]
    uy = 0.5 * (0.5 + (y - 0.5) * np.cos(th) - (z - 0.5) * np.sin(th) - y)
    uz = 0.5 * (0.5 + (y - 0.5) * np.sin(th) + (z - 0.5) * np.cos(th) - z)
    rot = max(np.abs(U[right, 1] - uy).max(), np.abs(U[right, 2] - uz).max(),
              np.abs(U[right, 0]).max())
    return float(np.abs(U[left]).max()), float(rot)


def _hessian_memory(tag, solver, form, device):
    """Seconds and peak device bytes of one Jacobian assembly of ``form``
    at the solver's solution, per cell of its cell term's largest chunk,
    against what the term's chunk allows a cell (``CHUNK_BYTES`` over its
    cells a chunk) and against the default model
    (``JACFWD_BYTES_PER_ENTRY`` an entry)."""
    import torch

    from fenicssolver_tpu_torch.ops import assembly

    u = torch.as_tensor(solver.result.values, dtype=solver.dtype,
                        device=solver.device)
    term = form.cell_terms[0]
    k = term.ctx.cell_dofs.shape[1]
    chunk = assembly._chunk_size(term)
    cells = min(chunk, term.ctx.cell_dofs.shape[0])
    if _on_card(device):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    J = assembly.assemble_jacobian(form, u)
    if _on_card(device):
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not _on_card(device):
        print(f"[{tag}] Jacobian assembly {dt:.3f} s; device memory not "
              f"measured (on {device})")
        return
    held = torch.cuda.max_memory_allocated() - base - J.data.numel() * 8
    per_cell = held / cells
    allowed = assembly.CHUNK_BYTES / chunk
    model = assembly.JACFWD_BYTES_PER_ENTRY * k * k
    print(f"[{tag}] Jacobian assembly {dt:.3f} s, k = {k}, {chunk} cells a "
          f"chunk, {cells} in the largest: {held / 2**20:.1f} MiB held beyond "
          f"the result, {per_cell:.0f} B a cell; the chunk allows "
          f"{allowed:.0f} ({per_cell / allowed:.2f}x), the default model "
          f"{model} ({per_cell / model:.2f}x)")
    check(per_cell <= 1.1 * allowed,
          f"the Jacobian holds {per_cell:.0f} B a cell, its chunk allows "
          f"{allowed:.0f}")


def phase_hyperelastic(device=None, n=N_TWIST, n_small=4):
    """The twist of examples/test_nonlinear_elasticity.py at the
    reference's own ``UnitCubeMesh(24, 16, 16)`` through ``main(settings)``:
    neo-Hookean, the element Hessian by forward-over-reverse autodiff,
    Newton with Jacobi-GMRES(80) updates (21,675 dofs > ``DENSE_LIMIT``);
    the Dirichlet data must hold exactly and the twisted face within 1e-10
    of the rotation.  Then the same case at ``UnitCubeMesh(n_small)`` on the
    card against the port on the CPU (rel-L2 1e-9, equal Newton steps)."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    _reset_peak(device)
    t0 = time.perf_counter()
    solver = run_main(twist_settings(core, n), device=device)
    wall = time.perf_counter() - t0
    if _on_card(device):
        check(solver.device.type == "cuda", f"the twist ran on {solver.device}")
    tt = solver.timers.totals
    left, rot = _twist_errors(solver)
    print(f"[hyperelastic] twist {n}: {solver.mesh.num_cells()} tets, "
          f"{solver.function_space.ndof} dofs on {solver.device}: main() "
          f"{wall:.2f} s, {solver.last_iterations} Newton steps; form "
          f"{tt['form']:.2f} s, Jacobians {tt['jacobian']:.2f} s, residuals "
          f"{tt['residual']:.2f} s, GMRES {tt['newton_solve']:.2f} s"
          + _peak_text(device))
    _newton_lines("hyperelastic", solver)
    print(f"[hyperelastic] max |u| on x = 0: {left:.3e}; max distance from "
          f"the rotation on x = 1: {rot:.3e} (tol 1e-10); max |u| "
          f"{np.abs(solver.result.values).max():.4f}")
    check(np.isfinite(solver.result.values).all(), "the twist is not finite")
    check(left == 0.0, f"the clamped face moved by {left}")
    check(rot < 1e-10, f"the twisted face is {rot} from the rotation")
    check(all(isinstance(s["iterations"], int) and s["relres"] <= 1e-10
              for s in solver.last_newton), "a GMRES update missed 1e-10")
    form, _ = solver.generate_form(0, None, None, solver.w_current,
                                   solver.w_current)
    _hessian_memory("hyperelastic", solver, form, device)
    del solver, form

    res = {}
    for where in (device, "cpu"):
        s = run_main(twist_settings(core, (n_small,) * 3), device=where)
        res[where] = (s.result.values.copy(), s.last_iterations, s.device)
    rel = _rel_l2(res[device][0], res["cpu"][0])
    print(f"[hyperelastic] twist {n_small}^3 on {res[device][2]}: {res[device][1]} "
          f"Newton steps, cpu {res['cpu'][1]}; rel-L2 {rel:.3e} (tol 1e-9)")
    check(rel <= 1e-9, f"twist card vs CPU rel-L2 {rel}")
    check(res[device][1] == res["cpu"][1], "Newton steps differ")


def contact_settings(core, nx, contact, delta=0.05):
    """examples/test_contact_mechanics.py's block on ``UnitSquareMesh(nx)``,
    pressed down by ``delta`` at y = 1 onto the obstacle ``contact``;
    Newton starts from the homogeneous compression u = (0, -delta y) (from
    u = 0 the top row of cells is inverted once h < delta)."""
    return {
        "solver_name": "NonlinearElasticitySolver",
        "mesh": core.UnitSquareMesh(nx, nx), "fe_degree": 1,
        "boundary_conditions": {"top": {
            "boundary": _on_plane(core, 1, 1.0), "boundary_id": 1,
            "type": "Dirichlet", "value": core.Constant((0.0, -delta))}},
        "contact_settings": dict(contact, boundary=_on_plane(core, 1, 0.0)),
        "initial_values": {"displacement": ("0.0", f"-{delta}*x[1]")},
        "material": {"elastic_modulus": 10.0, "poisson_ratio": 0.3,
                     "density": 1.0},
        "solver_settings": {
            "transient_settings": {"transient": False},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-11,
                                  "maximum_iterations": 60,
                                  "monitor_convergence": False},
        },
        "report_settings": dict(QUIET),
    }


def _top_reaction(solver):
    """The force the top constraint applies to the block, with its sign
    flipped: the unconstrained residual summed over the top dofs."""
    import torch

    from fenicssolver_tpu_torch.ops import assembly

    form, _ = solver.generate_form(0, None, None, solver.w_current,
                                   solver.w_current)
    R = assembly.assemble_residual(form, torch.as_tensor(
        solver.result.values, dtype=solver.dtype, device=solver.device))
    R = R.cpu().numpy().reshape(-1, 2)
    X = solver.function_space.scalar_space.dof_coords
    return R[abs(X[:, 1] - 1.0) < 1e-12].sum(axis=0)


def phase_contact(device=None, nx=N_CONTACT, nx_ball=N_BALL):
    """examples/test_contact_mechanics.py on the card: the block pressed
    onto a rigid plane with the penalty k = 1e4 and 1e5 (the contact force
    balances the top reaction, the two forces within 2%, the penetration
    ratio between 6 and 14), then indented by the rigid ball (engaged,
    symmetric, localized), all through ``main(settings)``."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    plane = {"obstacle": {"type": "plane", "point": (0.0, 0.0),
                          "normal": (0.0, 1.0)}}
    pens, forces = [], []
    for k in (1e4, 1e5):
        t0 = time.perf_counter()
        solver = run_main(contact_settings(core, nx, dict(plane, penalty=k)),
                          device=device)
        wall = time.perf_counter() - t0
        U = solver.result.values.reshape(-1, 2)
        X = solver.function_space.scalar_space.dof_coords
        bot = np.abs(X[:, 1]) < 1e-12
        pens.append(-(X[bot, 1] + U[bot, 1]).min())
        fc = solver.contact_force()
        reac = _top_reaction(solver)
        forces.append(fc[1])
        tt = solver.timers.totals
        print(f"[contact] plane, k = {k:.0e}, {nx} x {nx}: "
              f"{solver.function_space.ndof} dofs on {solver.device}, "
              f"main() {wall:.2f} s, {solver.last_iterations} Newton steps "
              f"({solver.last_newton[0]['iterations']} updates; Jacobians "
              f"{tt['jacobian']:.2f} s, solves {tt['newton_solve']:.2f} s); "
              f"contact force {fc[1]:.6f}, top reaction {-reac[1]:.6f} "
              f"(rel {abs(fc[1] + reac[1]) / fc[1]:.2e}, tol 2e-8); "
              f"penetration {pens[-1]:.3e}")
        check(pens[-1] > 1e-6 and fc[1] > 0.0, "the plane is not in contact")
        check(abs(fc[1] + reac[1]) < 2e-8 * abs(fc[1]),
              f"contact force {fc} against the top reaction {reac}")
        check(0.1 * 10 * 0.05 < fc[1] < 3.0 * 10 * 0.05, f"force {fc}")
    ratio = pens[0] / pens[1]
    spread = abs(forces[1] - forces[0]) / forces[0]
    print(f"[contact] penetration ratio {ratio:.3f} (6 .. 14); forces "
          f"{forces[0]:.6f} and {forces[1]:.6f} ({100 * spread:.3f}%, tol 2%)")
    check(6.0 < ratio < 14.0, f"penetration ratio {ratio}")
    check(spread < 0.02, f"forces {forces}")

    ball = {"obstacle": {"type": "sphere", "center": (0.5, -0.29),
                         "radius": 0.3}, "penalty": 1e4}
    solver = run_main(contact_settings(core, nx_ball, ball), device=device)
    U = solver.result.values.reshape(-1, 2)
    X = solver.function_space.scalar_space.dof_coords
    bot = np.abs(X[:, 1]) < 1e-12
    g = np.linalg.norm(X[bot] + U[bot] - np.array([0.5, -0.29]), axis=1) - 0.3
    xb = X[bot, 0]
    fc = solver.contact_force()
    print(f"[contact] ball, {nx_ball} x {nx_ball}: {solver.last_iterations} "
          f"Newton steps on {solver.device}; force ({fc[0]:.3e}, {fc[1]:.6f}); "
          f"max |gap| under the pole {np.abs(g[np.abs(xb - 0.5) < 0.15]).max():.2e}, "
          f"min gap at |x - 0.5| > 0.4 {g[np.abs(xb - 0.5) > 0.4].min():.3f}")
    check(fc[1] > 0.0 and abs(fc[0]) < 0.05 * fc[1], f"ball force {fc}")
    check((g[np.abs(xb - 0.5) > 0.4] > 0.05).all(), "the contact spread")


BAR = {"elastic_modulus": 200e3, "poisson_ratio": 0.3, "density": 7800.0,
       "yield_strength": 250.0, "hardening_modulus": 20e3}


def bar_settings(core, n):
    """tests/test_plasticity.py's bar on ``UnitCubeMesh(n)``: pulled along
    x on x = 1, rollers on x = 0, y = 0 and z = 0."""
    def roller(axis, value, bid, comps):
        return {"boundary": _on_plane(core, axis, value), "boundary_id": bid,
                "values": [{"variable": "displacement", "type": "Dirichlet",
                            "value": comps}]}

    return {
        "solver_name": "PlasticitySolver",
        "function_space": core.VectorFunctionSpace(core.UnitCubeMesh(n, n, n),
                                                   "CG", 1),
        "boundary_conditions": {
            "left": roller(0, 0.0, 1, (0.0, None, None)),
            "pull": roller(0, 1.0, 2, (0.0, None, None)),
            "y0": roller(1, 0.0, 3, (None, 0.0, None)),
            "z0": roller(2, 0.0, 4, (None, None, 0.0)),
        },
        "material": dict(BAR),
        "solver_settings": {
            "transient_settings": {"transient": False},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-11,
                                  "maximum_iterations": 60},
        },
        "vector_name": "displacement",
        "report_settings": dict(QUIET),
    }


def bilinear_stress(history):
    """The uniaxial stress of linear isotropic hardening J2 along a strain
    history (tests/test_plasticity.py's ``plastic_corrected``)."""
    E, sig_y, H = BAR["elastic_modulus"], BAR["yield_strength"], \
        BAR["hardening_modulus"]
    eps_p = sig = 0.0
    for eps in history:
        sig_tr = E * (eps - eps_p)
        flow = sig_y + H * eps_p
        if abs(sig_tr) > flow:
            dgam = (abs(sig_tr) - flow) / (E + H)
            eps_p += math.copysign(dgam, sig_tr)
            sig = math.copysign(flow + H * dgam, sig_tr)
        else:
            sig = sig_tr
    return sig


def phase_plasticity(device=None, n=N_PLASTIC):
    """The uniaxial bar of tests/test_plasticity.py on ``UnitCubeMesh(n)``
    (state ``epsp`` and ``alpha`` on the card), along its path to 2.4 times
    the yield strain and back to 1.9 (the unloading in n // 4 increments),
    by ``PlasticitySolver``'s load steps: Newton on the autodiff tangent of
    the return map, Jacobi-GMRES(80) updates.  Every quadrature point's
    sigma_xx within 1e-6 of the bilinear answer at every step; alpha frozen
    while unloading."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.solvers.plasticity import PlasticitySolver

    eps_y = BAR["yield_strength"] / BAR["elastic_modulus"]
    k = max(n // 4, 1)
    path = ([f * eps_y for f in (0.5, 1.2, 1.8, 2.4)]
            + [eps_y * (2.4 - 0.5 * (i + 1) / k) for i in range(k)])
    s = bar_settings(core, n)
    solver = PlasticitySolver(s, device=device)
    solver.init_solver()
    solver.current_time = 0.0
    state_mb = (solver._epsp.numel() + solver._alpha.numel()) * 8 / 1e6
    _reset_peak(device)
    t0 = time.perf_counter()
    worst, alphas = 0.0, []
    for i, eps in enumerate(path):
        s["boundary_conditions"]["pull"]["values"][0]["value"] = (eps, None, None)
        solver.current_step = i
        t1 = time.perf_counter()
        solver.solve_current_step()
        dt = time.perf_counter() - t1
        sxx = solver.cauchy_stress_qp()[:, :, 0, 0].cpu().numpy()
        exact = bilinear_stress(path[: i + 1])
        err = float(np.abs(sxx - exact).max() / abs(exact))
        worst = max(worst, err)
        alphas.append(solver.equivalent_plastic_strain().clone())
        gm = [st["iterations"] for st in solver.last_newton]
        print(f"[plasticity] step {i}: strain {eps / eps_y:.4f} eps_y, "
              f"{solver.last_iterations} Newton steps, GMRES {gm}, {dt:.2f} s; "
              f"sigma_xx {float(sxx.mean()):.4f} (bilinear {exact:.4f}, max "
              f"rel error {err:.2e}); alpha max "
              f"{float(alphas[-1].max()):.4e}")
        check(err <= 1e-6, f"step {i}: sigma_xx off by {err}")
    wall = time.perf_counter() - t0
    frozen = all(bool((a == alphas[3]).all()) for a in alphas[4:])
    tt = solver.timers.totals
    print(f"[plasticity] bar {n}^3: {solver.mesh.num_cells()} tets, "
          f"{solver.function_space.ndof} dofs, state {state_mb:.1f} MB on "
          f"{solver._epsp.device}: {len(path)} load steps in {wall:.2f} s "
          f"(forms {tt['form']:.2f} s, Jacobians {tt['jacobian']:.2f} s, "
          f"residuals {tt['residual']:.2f} s, GMRES {tt['newton_solve']:.2f} s)"
          f"; worst sigma_xx error {worst:.2e} (tol 1e-6); alpha frozen while "
          f"unloading: {frozen}" + _peak_text(device))
    check(frozen, "alpha moved while unloading")
    form, _ = solver.generate_form(len(path), None, None, solver.w_current,
                                   solver.w_current)
    _hessian_memory("plasticity", solver, form, device)


def beam_settings(core, n, nu):
    """examples/test_large_deformation.py's beam: 2 x 0.2 on n x max(n // 8,
    2) cells, clamped (displacement and velocity) at x = 0, a force (0, 5)
    on x = 2, E = 1e5, four Crank-Nicolson steps of 0.05."""
    left, right = _on_plane(core, 0, 0.0), _on_plane(core, 0, 2.0)
    return {
        "solver_name": "LargeDeformationSolver",
        "mesh": core.RectangleMesh(core.Point(0, 0), core.Point(2.0, 0.2), n,
                                   max(n // 8, 2)),
        "fe_degree": 1,
        "boundary_conditions": {
            "fixed": {"boundary": left, "boundary_id": 1, "type": "Dirichlet",
                      "variable": "displacement", "value": (0.0, 0.0)},
            "fixed_velocity": {"boundary": left, "boundary_id": 1,
                               "type": "Dirichlet", "variable": "velocity",
                               "value": (0.0, 0.0)},
            "stress_b": {"boundary": right, "boundary_id": 2, "type": "force",
                         "value": (0, 5)},
        },
        "material": {"elastic_modulus": 1e5, "poisson_ratio": nu,
                     "density": 1000, "thermal_expansion_coefficient": 2e-6},
        "solver_settings": {
            "transient_settings": {"transient": True, "starting_time": 0,
                                   "time_step": 0.05, "ending_time": 0.2},
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-8,
                                  "maximum_iterations": 50,
                                  "monitor_convergence": False},
        },
        "report_settings": dict(QUIET),
    }


def phase_large_deformation(device=None, n=N_BEAM, n_check=16):
    """examples/test_large_deformation.py's beam at ``n`` x ``n // 8``
    (mixed P1 displacement, velocity and pressure, dense LU Newton updates)
    for nu = 0.3 and 0.5 through ``main(settings)``: finite, the tip
    displacement printed; then the example's own n = 16 on the card against
    the port on the CPU (displacement and velocity to 1e-9; the pressure too
    at nu = 0.3: at nu = 0.5 the P1/P1/P1 space leaves it non-unique)."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    for nu in (0.3, 0.5):
        t0 = time.perf_counter()
        solver = run_main(beam_settings(core, n, nu), device=device)
        wall = time.perf_counter() - t0
        U = solver.displacement().values.reshape(-1, 2)
        X = solver.function_space.subspaces[0].scalar_space.dof_coords
        tip = U[np.abs(X[:, 0] - 2.0) < 1e-9].mean(axis=0)
        tt = solver.timers.totals
        print(f"[large-deformation] beam {n} x {max(n // 8, 2)}, nu = {nu}: "
              f"{solver.function_space.ndof} dofs on {solver.device}, "
              f"{solver.steps_taken} CN steps in {wall:.2f} s (forms "
              f"{tt['form']:.2f} s, Jacobians {tt['jacobian']:.2f} s, dense "
              f"LU {tt['newton_solve']:.2f} s), last step "
              f"{solver.last_iterations} Newton steps; tip displacement "
              f"({tip[0]:.6e}, {tip[1]:.6e})")
        check(np.isfinite(solver.result.values).all(), "the beam is not finite")
        check(tip[1] > 0, f"the tip moved {tip}")
    for nu in (0.3, 0.5):
        res = {}
        for where in (device, "cpu"):
            s = run_main(beam_settings(core, n_check, nu), device=where)
            res[where] = (s.result.values.copy(), s.last_iterations,
                          s.function_space, s.device)
        W = res["cpu"][2]
        blocks = (0, 1) if nu == 0.5 else (0, 1, 2)
        rel = max(_rel_l2(res[device][0][W.slice_of(b)],
                          res["cpu"][0][W.slice_of(b)]) for b in blocks)
        print(f"[large-deformation] beam {n_check}, nu = {nu}, on "
              f"{res[device][3]} against the CPU: rel-L2 {rel:.3e} over blocks "
              f"{blocks} (tol 1e-9); Newton steps {res[device][1]} and "
              f"{res['cpu'][1]}")
        check(rel <= 1e-9, f"beam card vs CPU rel-L2 {rel}")


def dynamics_settings(core, n, steps):
    """tests/test_fast_paths.py's elastodynamics case on a 10 x 1 x 1 steel
    bar of ``n`` cells: clamped at x = 0, a body force of -1e6 along z,
    ``steps`` steps of 0.01 with the explicit inertia of the history."""
    mesh = core.BoxMesh(core.Point(0, 0, 0), core.Point(10, 1, 1), *n)
    V = core.VectorFunctionSpace(mesh, "CG", 1)
    bcs = {"fixed": {"boundary": _on_plane(core, 0, 0.0), "boundary_id": 1,
                     "type": "Dirichlet", "value": core.Constant((0, 0, 0))}}
    s = elasticity_settings(V, bcs, rtol=1e-12, body_source=(0.0, 0.0, -1e6))
    s["solver_settings"]["transient_settings"] = {
        "transient": True, "starting_time": 0.0, "time_step": 0.01,
        "ending_time": (steps - 0.5) * 0.01}
    return s


def phase_elastodynamics(device=None, n=N_DYNAMICS, n_loop=N_DYNAMICS_LOOP,
                         steps=5, timed_steps=10):
    """``fast_paths.compile_transient_elasticity_dynamics``: ``steps`` steps
    at ``n_loop`` against as many steps of the time loop with
    ``solving_dynamics`` (rel-L2 1e-6); at ``n`` its set-up (the form and K,
    assembled once), ``steps`` steps (finite, each step's PCG under its
    cap) and then ``timed_steps`` steps for the seconds and the Jacobi-PCG
    iterations a step."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.solvers.fast_paths import (
        compile_transient_elasticity_dynamics,
    )
    from fenicssolver_tpu_torch.solvers.linear_elasticity import (
        LinearElasticitySolver,
    )

    def sync():
        if _on_card(device):
            torch.cuda.synchronize()

    fast = LinearElasticitySolver(dynamics_settings(core, n_loop, steps),
                                  device=device)
    run, aux = compile_transient_elasticity_dynamics(fast, 0.01, steps, tol=1e-12)
    u0 = fast.w_current.values
    u_fast, _ = run(u0, u0)
    loop = LinearElasticitySolver(dynamics_settings(core, n_loop, steps),
                                  device=device)
    loop.solving_dynamics = True
    t0 = time.perf_counter()
    u_loop = loop.solve().values
    loop_s = time.perf_counter() - t0
    rel = _rel_l2(u_fast.cpu().numpy(), u_loop)
    print(f"[elastodynamics] {n_loop}: {fast.function_space.ndof} dofs on "
          f"{fast.device}: {steps} fast-path steps against {loop.steps_taken} "
          f"steps of the time loop ({loop.last_preconditioner}-"
          f"{loop.last_krylov}, {loop_s:.2f} s): rel-L2 {rel:.3e} (tol 1e-6); "
          f"PCG iterations {aux['iterations']}")
    check(loop.steps_taken == steps, f"the loop took {loop.steps_taken} steps")
    check(rel <= 1e-6, f"fast path vs time loop rel-L2 {rel}")
    del fast, loop, run, aux

    _reset_peak(device)
    for count in (steps, timed_steps):
        solver = LinearElasticitySolver(dynamics_settings(core, n, count),
                                        device=device)
        sync()
        t0 = time.perf_counter()
        run, aux = compile_transient_elasticity_dynamics(
            solver, 0.01, count, maxiter=DYNAMICS_MAXITER)
        sync()
        setup = time.perf_counter() - t0
        u0 = solver.w_current.values
        t0 = time.perf_counter()
        u, norms = run(u0, u0)
        sync()
        wall = time.perf_counter() - t0
        its = aux["iterations"]
        print(f"[elastodynamics] {n}: {solver.mesh.num_cells()} tets, "
              f"{solver.function_space.ndof} dofs on {solver.device}: set-up "
              f"{setup:.2f} s (form and K once), {count} steps in {wall:.2f} s, "
              f"{wall / count:.4f} s a step; Jacobi-PCG iterations a step: "
              f"min {min(its)}, median {int(np.median(its))}, max {max(its)} "
              f"(first {its[:5]}); |u| {float(norms[0]):.4e} after the first "
              f"step, {float(norms[-1]):.4e} after the last" + _peak_text(device))
        check(bool(torch.isfinite(u).all()), "the fast path is not finite")
        check(max(its) < DYNAMICS_MAXITER, f"a PCG solve hit its cap: {max(its)}")
        del solver, run, aux, u


def conductivity_problem(core, nx, device):
    """The heat problem of examples/test_adjoint_inverse.py on
    ``UnitSquareMesh(nx)``: -div(kappa grad u) = 1, u = 0 on the boundary,
    kappa per cell in the form's aux."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.ops import assembly, geometry

    mesh = core.UnitSquareMesh(nx, nx)
    V = core.FunctionSpace(mesh, "CG", 1)
    tab = geometry.basis_tables(mesh.tdim, 1, 2)
    dphi, qw, phi = (torch.tensor(a, dtype=torch.float64, device=device)
                     for a in (tab.dphi, tab.qw, tab.phi))

    def kern(ue, geom, aux):
        dphig = geometry.phys_grads(dphi, geom.Jinv)
        g = geometry.interp_grad(dphig, ue)
        diff = aux["kappa"] * torch.einsum("q,qg,qig->i", qw, g, dphig)
        return (diff - torch.einsum("q,qi->i", qw, phi)) * geom.detJ

    nc = mesh.num_cells()
    form = assembly.Form(space=V)
    form.cell_terms.append(assembly.CellTerm(
        kernel=kern, ctx=geometry.build_cell_context(V, 2, device=device),
        aux={"kappa": torch.ones(nc, dtype=torch.float64, device=device)}))
    form.finalize()
    d = assembly.DirichletData(V.ndof)
    bd = np.asarray(V.facet_dofs(mesh.exterior_facets()))
    d.add(bd, np.zeros(len(bd)))
    d.finalize(device=device)
    return mesh, form, d


def phase_adjoint(device="cuda", nx=24, n=N_ADJOINT, iters=200):
    """``ops/adjoint.make_implicit_solver`` on the card.  (1) The inverse
    conductivity problem of examples/test_adjoint_inverse.py at ``nx``:
    ``torch.optim.Adam`` (lr 0.25, the example's ``optax.adam``) on the
    adjoint gradient of the log-conductivity, ``iters`` steps, with the
    example's assertions.  (2) At ``UnitSquareMesh(n)`` the gradient of
    sum(u^2) with respect to kappa at two cells against central
    differences (eps 1e-3, CG to 1e-14; 1e-6 relative), and two gradient
    calls bit-equal."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.ops.adjoint import make_implicit_solver

    mesh, form, d = conductivity_problem(core, nx, device)
    solver = make_implicit_solver(form, d, linear=True, spd=True)
    nc = mesh.num_cells()
    cc = mesh.coords[mesh.cells_array].mean(axis=1)
    inside = (np.abs(cc[:, 0] - 0.5) < 0.15) & (np.abs(cc[:, 1] - 0.5) < 0.15)
    kappa_true = torch.tensor(np.where(inside, 3.0, 1.0), device=device)
    u_meas = solver({"kappa": kappa_true}).detach()

    def loss(log_kappa):
        u = solver({"kappa": torch.exp(log_kappa)})
        return ((u - u_meas) ** 2).sum() / (u_meas ** 2).sum()

    theta = torch.zeros(nc, dtype=torch.float64, device=device,
                        requires_grad=True)
    opt = torch.optim.Adam([theta], lr=0.25)
    with torch.no_grad():
        l0 = float(loss(theta))
    t0 = time.perf_counter()
    for _ in range(iters):
        opt.zero_grad()
        loss(theta).backward()
        opt.step()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        lN = float(loss(theta))
    rec = torch.exp(theta.detach()).cpu().numpy()
    mean_in, mean_out = float(rec[inside].mean()), float(rec[~inside].mean())
    print(f"[adjoint] inverse conductivity {nx} x {nx} on {device}: {nc} "
          f"parameters, {iters} Adam steps in {wall:.2f} s "
          f"({1e3 * wall / iters:.1f} ms a step: one forward and one adjoint "
          f"solve); mismatch {l0:.3e} -> {lN:.3e}; kappa inside "
          f"{mean_in:.3f} (true 3), outside {mean_out:.3f} (true 1)")
    check(lN < 1e-3 * l0, f"mismatch {l0} -> {lN}")
    check(abs(mean_out - 1.0) < 0.05 and mean_in > 2.0,
          f"recovered kappa {mean_in}, {mean_out}")

    mesh, form, d = conductivity_problem(core, n, device)
    solver = make_implicit_solver(form, d, linear=True, spd=True, tol=1e-14,
                                  maxiter=20000)
    nc = mesh.num_cells()
    kappa = torch.tensor(1.0 + 0.5 * np.random.default_rng(0).random(nc),
                         device=device)

    def J(k):
        return (solver({"kappa": k}) ** 2).sum()

    grad = torch.func.grad(J)
    t0 = time.perf_counter()
    g1 = grad(kappa)
    g_s = time.perf_counter() - t0
    g2 = grad(kappa)
    eps = 1e-3
    worst = 0.0
    for c in (nc // 3, 2 * nc // 3 + 5):
        e = torch.zeros(nc, dtype=torch.float64, device=device)
        e[c] = eps
        with torch.no_grad():
            fd = (float(J(kappa + e)) - float(J(kappa - e))) / (2 * eps)
        rel = abs(float(g1[c]) - fd) / abs(fd)
        worst = max(worst, rel)
        print(f"[adjoint] {n} x {n} ({nc} cells, {form.space.ndof} dofs): "
              f"dJ/dkappa[{c}] adjoint {float(g1[c]):.12e}, central difference "
              f"{fd:.12e} (rel {rel:.2e}, tol 1e-6)")
    equal = bool(torch.equal(g1, g2))
    print(f"[adjoint] gradient in {g_s:.2f} s (forward and adjoint CG to "
          f"1e-14); two calls bit-equal: {equal}")
    check(worst <= 1e-6, f"adjoint vs central differences: {worst}")
    check(equal, "two adjoint gradients differ")


# --------------------------------------------------------------------------
# Navier-Stokes (the ninth slice)
# --------------------------------------------------------------------------

#: DFG-2D-1 (Schaefer & Turek 1996): channel 2.2 x 0.41, cylinder at
#: (0.2, 0.2) of radius 0.05, U_m = 0.3, nu = 1e-3, rho = 1 (Re = 20);
#: published C_D = 5.5795, C_L = 0.0106 (examples/test_flow_pass_cylinder.py)
DFG_L, DFG_H, DFG_C, DFG_R, DFG_UM, DFG_NU = 2.2, 0.41, (0.2, 0.2), 0.05, 0.3, 1e-3
C_D_REF = 5.5795
#: the DFG mesh's resolution and cylinder points: ~50,800 Taylor-Hood dofs,
#: the size the reference takes its sparse-direct drag anchor at
N_DFG = (32, 64)
N_DFG_PCD = (16, 32)
N_DFG_BIG = (64, 128)
#: the fieldsplit FGMRES's outer budget on the DFG mesh: at the reference's
#: default, FGMRES(120) x 8, the four advective Newton updates end at rel
#: res 1.8e-2..4.5e-2 and fall back to SuperLU, in the JAX package too
#: (``probe_ns_budgets``); FGMRES(400) x 3 takes them to 1e-4..4e-4
DFG_BUDGET = (400, 3)


def dfg_settings(core, res, circle_pts=None, nu=DFG_NU, transient=False,
                 **params):
    """examples/test_flow_pass_cylinder.py's ``make_settings``: the DFG
    channel from ``meshgen.rectangle_with_hole``, parabolic inflow, p = 0 at
    the outlet, no-slip walls and cylinder (boundary 4), rtol 1e-8;
    ``params`` go into ``solver_parameters``."""
    from fenicssolver_tpu_torch.core.meshgen import rectangle_with_hole

    near = core.near
    cx, cy = DFG_C

    def bc(bid, pred, value, variable="velocity"):
        return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
                "values": [{"variable": variable, "type": "Dirichlet",
                            "value": value}]}

    inflow = core.Expression(("4.0*Um*x[1]*(H - x[1])/(H*H)", "0"), Um=DFG_UM,
                             H=DFG_H, degree=2)
    return {
        "solver_name": "CoupledNavierStokesSolver",
        "mesh": rectangle_with_hole((0, 0), (DFG_L, DFG_H), DFG_C, DFG_R, res,
                                    circle_pts=circle_pts),
        "fe_degree": 1,
        "boundary_conditions": {
            "inlet": bc(1, lambda x: near(x[0], 0.0), inflow),
            "outlet": bc(2, lambda x: near(x[0], DFG_L), 0.0, "pressure"),
            "walls": bc(3, lambda x: near(x[1], 0.0) | near(x[1], DFG_H),
                        (0.0, 0.0)),
            "cylinder": bc(4, lambda x: (x[0] - cx) ** 2 + (x[1] - cy) ** 2
                           < (DFG_R * 1.2) ** 2, (0.0, 0.0)),
        },
        "body_source": None,
        "initial_values": {"velocity": (0.0, 0.0), "pressure": 0.0},
        "material": {"density": 1.0, "kinematic_viscosity": nu},
        "solver_settings": {
            "transient_settings": {"transient": transient, "starting_time": 0,
                                   "time_step": 0.05, "ending_time": 0.15},
            "reference_values": {"pressure": 101325.0},
            "solver_parameters": dict({"relative_tolerance": 1e-8,
                                       "maximum_iterations": 100,
                                       "monitor_convergence": False}, **params),
        },
        "report_settings": dict(QUIET),
    }


def dfg_coefficients(solver, up):
    """(C_D, C_L) on the cylinder: 2 F / (rho ubar^2 D), ubar = 2/3 U_m."""
    ubar = 2.0 / 3.0 * DFG_UM
    drag, lift = solver.calc_drag_and_lift(up, 0, 1, [4])
    scale = 2.0 / (ubar * ubar * 2 * DFG_R)
    return scale * drag, scale * lift


def ns_channel(core, nx, ny=None, transient=False):
    """tests/test_navier_stokes.py's ``channel_settings``: the unit square,
    Poiseuille inflow (U = 0.3), p = 0 at x = 1, rho = 1000, nu = 0.05,
    rtol 1e-11; backward Euler of 0.05 up to 0.2 when ``transient``."""
    near = core.near

    def bc(bid, pred, value, variable="velocity"):
        return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
                "values": [{"variable": variable, "type": "Dirichlet",
                            "value": value}]}

    parabola = core.Expression(("umax*4.0*x[1]*(1.0-x[1])", "0"), umax=0.3,
                               degree=2)
    return {
        "solver_name": "CoupledNavierStokesSolver",
        "mesh": core.UnitSquareMesh(nx, ny or nx), "fe_degree": 1,
        "boundary_conditions": {
            "inlet": bc(1, lambda x: near(x[0], 0.0), parabola),
            "outlet": bc(2, lambda x: near(x[0], 1.0), 0.0, "pressure"),
            "top": bc(3, lambda x: near(x[1], 1.0), (0.0, 0.0)),
            "bottom": bc(4, lambda x: near(x[1], 0.0), (0.0, 0.0)),
        },
        "body_source": None,
        "initial_values": {"velocity": (0.0, 0.0), "pressure": 0.0},
        "material": {"density": 1000.0, "kinematic_viscosity": 0.05},
        "solver_settings": {
            "transient_settings": {"transient": transient, "starting_time": 0,
                                   "time_step": 0.05, "ending_time": 0.2},
            "reference_values": {"temperature": 293, "pressure": 101325},
            "solver_parameters": {"relative_tolerance": 1e-11,
                                  "maximum_iterations": 100,
                                  "monitor_convergence": False},
        },
        "report_settings": dict(QUIET),
    }


def _ns_newton_lines(tag, solver, what=""):
    """One line a Newton step of an NS solve: the route, the outer
    iterations and relative residual, and the seconds of its parts."""
    for k, st in enumerate(solver.last_newton, start=1):
        rel = "" if st["relres"] is None else f", rel res {st['relres']:.2e}"
        print(f"[{tag}] {what}Newton step {k}: {st['route']} "
              f"({st['iterations']}{rel}), Jacobian {st['jacobian_s']:.3f} s, "
              f"solve {st['solve_s']:.3f} s, residual "
              f"{st.get('residual_s', float('nan')):.3f} s")


def _ns_timers(solver):
    tt = solver.timers.totals
    names = ("form", "jacobian", "residual", "momentum_amg_setup",
             "pcd_setup", "bcorr", "saddle_setup", "fgmres", "splu",
             "newton_solve")
    return ", ".join(f"{n} {tt[n]:.2f} s" for n in names if n in tt)


def profile_fgmres_iteration(solver, iterations=20):
    """Of the solver's saddle-point solve at its solution: the wall ms of
    one FGMRES outer iteration (``iterations`` of them from zero, restart
    beyond them) and, from ``torch.profiler``, the device-busy ms of one and
    so the idle share.  Also two solves of the same system from zero (120
    outer iterations at most): their outer iterations and whether their
    results are bit-equal."""
    import torch

    from fenicssolver_tpu_torch.la import krylov
    from fenicssolver_tpu_torch.ops import assembly

    form, dd = solver.generate_form(0, None, None, solver.w_current,
                                    solver.w_current)
    u = torch.as_tensor(solver.w_current.values, dtype=solver.dtype,
                        device=solver.device)
    J = assembly.assemble_jacobian(form, u)
    fm = dd.free_mask
    M = solver._block_preconditioner(J, fm)
    op = assembly.constrained_operator(J.matvec, fm)
    rhs = fm * torch.sin(torch.arange(u.numel(), dtype=u.dtype,
                                      device=u.device))

    def some():
        return krylov.fgmres(op, rhs, M=M, tol=0.0, restart=iterations + 1,
                             maxiter=1)

    some()
    sync = torch.cuda.synchronize if u.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    some()
    sync()
    wall = (time.perf_counter() - t0) / iterations * 1e3
    prof = _profiled(some, 1) if u.is_cuda else None
    if prof is None:
        dev = "device busy not measured"
    else:
        busy, _, events = prof
        busy, events = busy / iterations, events / iterations
        dev = (f"device busy {busy:.3f} ms ({events:.0f} device events), "
               f"idle {100 * (1 - busy / wall):.1f}%")
    x1, it1, r1 = krylov.fgmres(op, rhs, M=M, tol=1e-9, restart=120, maxiter=1)
    x2, it2, r2 = krylov.fgmres(op, rhs, M=M, tol=1e-9, restart=120, maxiter=1)
    return wall, dev, (it1, it2, bool(torch.equal(x1, x2)), r1)


def phase_ns_dfg(device=None, dfg=N_DFG, pcd=N_DFG_PCD, res_cpu=8,
                 budget=DFG_BUDGET):
    """DFG-2D-1 steady through ``main(settings)`` on the default device:
    ``rectangle_with_hole(res, circle_pts)``, Taylor-Hood, f64, rtol 1e-8,
    no preconditioner set, so every Newton update is the ``fieldsplit``
    FGMRES, with the outer budget ``budget`` (``gmres_restart``,
    ``gmres_maxiter``; see ``DFG_BUDGET``); C_D within 5% of 5.5795 and
    |C_L| < 0.05 (examples/test_flow_pass_cylinder.py).  One line a Newton step, the
    seconds of each part, one outer iteration's wall and device time, two
    solves of one system bit-equal; then the same mesh by ``splu`` (SuperLU
    on the host: the yardstick), ``pcd`` with ``pcd_bc: robin`` at ``pcd``,
    and at ``res_cpu`` the card against the port on the CPU (the dense
    route on both, 1e-8).  Returns the monolithic drag and the solver."""
    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    res, pts = dfg
    _reset_peak(device)
    t0 = time.perf_counter()
    solver = run_main(dfg_settings(core, res, pts, gmres_restart=budget[0],
                                   gmres_maxiter=budget[1]), device=device)
    wall = time.perf_counter() - t0
    if _on_card(device):
        check(solver.device.type == "cuda", f"DFG ran on {solver.device}")
    up = solver.result
    cd, cl = dfg_coefficients(solver, up)
    routes = [st["route"] for st in solver.last_newton]
    print(f"[ns-dfg] DFG-2D-1 res {res}/{pts}: {solver.mesh.num_cells()} "
          f"triangles, {solver.function_space.ndof} dofs on {solver.device}: "
          f"main() {wall:.2f} s, {solver.last_iterations} Newton steps; "
          f"{_ns_timers(solver)}" + _peak_text(device))
    _ns_newton_lines("ns-dfg", solver)
    print(f"[ns-dfg] C_D = {cd:.5f} ({100 * (cd - C_D_REF) / C_D_REF:+.3f}% of "
          f"{C_D_REF}), C_L = {cl:.5f}")
    check(routes and set(routes) == {"fieldsplit"},
          f"a Newton update left the fieldsplit route: {routes}")
    if dfg == N_DFG:  # the example's bounds hold at its size, not below
        check(solver.function_space.ndof > 50000, "the DFG mesh is below 50k")
        check(abs(cd - C_D_REF) / C_D_REF < 0.05, f"C_D {cd} not within 5%")
        check(abs(cl) < 0.05, f"|C_L| = {abs(cl)}")
    form, _ = solver.generate_form(0, None, None, solver.w_current,
                                   solver.w_current)
    _hessian_memory("ns-dfg", solver, form, device)
    del form
    wall_it, dev, (it1, it2, same, r1) = profile_fgmres_iteration(solver)
    print(f"[ns-dfg] one FGMRES outer iteration at the solution: {wall_it:.3f} "
          f"ms wall, {dev}; two solves from zero: {it1} and {it2} outer "
          f"(rel res {r1:.1e}), bit-equal {same}")
    check(it1 == it2 and same, "two FGMRES solves of one system differ")
    drag = solver.calc_drag_and_lift(up, 0, 1, [4])[0]

    t0 = time.perf_counter()
    lu = run_main(dfg_settings(core, res, pts, preconditioner="splu"),
                  device=device)
    wall_lu = time.perf_counter() - t0
    cd_lu, _ = dfg_coefficients(lu, lu.result)
    print(f"[ns-dfg] the same mesh by splu (SuperLU on the host): main() "
          f"{wall_lu:.2f} s, {lu.last_iterations} Newton steps, splu "
          f"{lu.timers.totals['splu']:.2f} s; C_D = {cd_lu:.5f}; fieldsplit "
          f"{'wins' if wall < wall_lu else 'loses'} ({wall:.2f} s against "
          f"{wall_lu:.2f} s); the two solutions' rel-L2 "
          f"{_rel_l2(up.values, lu.result.values):.2e}")
    check({st["route"] for st in lu.last_newton} == {"splu"}, "splu route")
    del lu

    t0 = time.perf_counter()
    pc = run_main(dfg_settings(core, pcd[0], pcd[1], preconditioner="pcd",
                               pcd_bc="robin", gmres_maxiter=12),
                  device=device)
    cd_pc, _ = dfg_coefficients(pc, pc.result)
    print(f"[ns-dfg] pcd (robin) at res {pcd[0]}/{pcd[1]}, "
          f"{pc.function_space.ndof} dofs: main() "
          f"{time.perf_counter() - t0:.2f} s, {pc.last_iterations} Newton "
          f"steps; {_ns_timers(pc)}; C_D = {cd_pc:.5f}")
    _ns_newton_lines("ns-dfg", pc, "pcd ")
    check(pcd != N_DFG_PCD or abs(cd_pc - C_D_REF) / C_D_REF < 0.05,
          f"pcd C_D {cd_pc}")
    del pc

    out = {}
    for where in (device, "cpu"):
        s = run_main(dfg_settings(core, res_cpu, 4 * res_cpu), device=where)
        out[where] = (s.result.values.copy(), s.last_iterations,
                      {st["route"] for st in s.last_newton}, s.device)
    rel = _rel_l2(out[device][0], out["cpu"][0])
    print(f"[ns-dfg] res {res_cpu} ({s.function_space.ndof} dofs, dense LU) on "
          f"{out[device][3]} against the cpu: rel-L2 {rel:.2e} (tol 1e-8); "
          f"Newton steps {out[device][1]} and {out['cpu'][1]}")
    check(rel <= 1e-8, f"DFG card vs CPU rel-L2 {rel}")
    check(out[device][2] == out["cpu"][2] == {"dense"}, "routes differ")
    return drag, solver


def probe_ns_budgets(device=None, dfg=N_DFG, budgets=((120, 8), (400, 3))):
    """DFG-2D-1 through ``main(settings)`` by ``fieldsplit`` at each outer
    budget ``(gmres_restart, gmres_maxiter)``: the seconds of ``main()`` and
    one line a Newton step (route, outer iterations, rel res)."""
    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    for restart, maxiter in budgets:
        t0 = time.perf_counter()
        s = run_main(dfg_settings(core, *dfg, gmres_restart=restart,
                                  gmres_maxiter=maxiter), device=device)
        print(f"[ns-budget] res {dfg[0]}/{dfg[1]}, {s.function_space.ndof} "
              f"dofs, restart {restart} x {maxiter}: main() "
              f"{time.perf_counter() - t0:.2f} s; {_ns_timers(s)}")
        _ns_newton_lines("ns-budget", s)


def phase_ns_transient(device=None, res=10, nx_check=22, steps=3, nx_timed=64,
                       steps_timed=1):
    """The backward-Euler loop on the restart idiom of
    examples/test_flow_pass_cylinder.py at ``res`` (the steady Newton
    solve, then three transient Picard steps from it); then
    ``compile_transient_ns`` on the ``nx_check`` channel (3 steps of 0.05,
    8 Newton updates each, FGMRES beyond 4,096 dofs) within 1e-6 of the time
    loop (tests/test_fast_paths.py), and its set-up, seconds a step and
    FGMRES iterations over ``steps_timed`` steps on the ``nx_timed``
    channel."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.solvers import fast_paths
    from fenicssolver_tpu_torch.solvers.navier_stokes import (
        CoupledNavierStokesSolver,
    )

    t0 = time.perf_counter()
    steady = run_main(dfg_settings(core, res, nu=0.0015), device=device)
    t1 = time.perf_counter()
    s2 = dfg_settings(core, res, nu=0.0015, transient=True)
    s2["initial_values"] = steady.result
    loop = CoupledNavierStokesSolver(s2, device=device)
    loop.using_nonlinear_solver = False
    up = loop.solve()
    t2 = time.perf_counter()
    drag, _ = loop.calc_drag_and_lift(up, 0, 1, [4])
    print(f"[ns-transient] restart at res {res}, {steady.function_space.ndof} "
          f"dofs on {loop.device}: steady Newton {t1 - t0:.2f} s "
          f"({steady.last_iterations} steps), then {loop.steps_taken} Picard "
          f"steps in {t2 - t1:.2f} s ({loop.picard_iterations} iterations in "
          f"the last); drag {drag:.5g}")
    check(np.isfinite(up.values).all() and drag > 0, "the restart run")
    check(loop.steps_taken == 3, f"{loop.steps_taken} transient steps")
    del steady, loop

    dt = 0.05
    s = ns_channel(core, nx_check, transient=True)
    s["solver_settings"]["transient_settings"]["ending_time"] = dt * steps - dt / 2
    w_loop = CoupledNavierStokesSolver(s, device=device).solve().values
    fast = CoupledNavierStokesSolver(ns_channel(core, nx_check, transient=True),
                                     device=device)
    run, aux = fast_paths.compile_transient_ns(fast, dt, steps, newton_iters=8)
    w, _ = run(fast.get_initial_field().values)
    rel = _rel_l2(w.cpu().numpy(), w_loop)
    print(f"[ns-transient] compile_transient_ns {nx_check} x {nx_check} "
          f"({fast.function_space.ndof} dofs), {steps} steps against the time "
          f"loop: rel-L2 {rel:.2e} (tol 1e-6); FGMRES iterations "
          f"{aux['iterations']}")
    check(fast.function_space.ndof > fast_paths.DENSE_NS, "the dense route ran")
    check(rel < 1e-6, f"compile_transient_ns vs the loop {rel}")
    del fast, run

    _reset_peak(device)
    t0 = time.perf_counter()
    big = CoupledNavierStokesSolver(ns_channel(core, nx_timed, transient=True),
                                    device=device)
    run, aux = fast_paths.compile_transient_ns(big, dt, steps_timed)
    w0 = big.get_initial_field().values
    _sync(device)
    t1 = time.perf_counter()
    w, norms = run(w0)
    _sync(device)
    t2 = time.perf_counter()
    print(f"[ns-transient] compile_transient_ns {nx_timed} x {nx_timed} "
          f"({big.function_space.ndof} dofs): set-up {t1 - t0:.2f} s, "
          f"{(t2 - t1) / steps_timed:.3f} s a step (6 Newton updates); FGMRES "
          f"iterations {aux['iterations']}" + _peak_text(device))
    check(bool(np.isfinite(norms.cpu().numpy()).all()), "non-finite norms")


def _sync(device):
    import torch

    if _on_card(device):
        torch.cuda.synchronize()


def _ipcs_run(solver, dt, steps, device, **kw):
    """(u, p, norms, iterations a step (k1, k2, k3), set-up s, run s)."""
    import numpy as np

    from fenicssolver_tpu_torch.solvers import fast_paths

    t0 = time.perf_counter()
    run, aux = fast_paths.compile_transient_ns_ipcs(solver, dt=dt,
                                                    n_steps=steps,
                                                    report_iters=True, **kw)
    _sync(device)
    t1 = time.perf_counter()
    (u, p), (norms, k1, k2, k3) = run(np.zeros(aux["V"].ndof),
                                      np.zeros(aux["Q"].ndof))
    _sync(device)
    t2 = time.perf_counter()
    ks = [k.cpu().numpy() for k in (k1, k2, k3)]
    return u, p, norms.cpu().numpy(), ks, t1 - t0, t2 - t1


def _iters_text(ks):
    return ", ".join(f"{n} {k.mean():.1f} (max {k.max()})"
                     for n, k in zip(("BiCGStab", "AMG-PCG", "PCG"), ks))


def phase_ns_ipcs(device=None, drag_ref=None, dfg=N_DFG, dt=0.004, steps=500,
                  big=N_DFG_BIG, big_steps=40, mf_steps=20):
    """``compile_transient_ns_ipcs`` on the DFG mesh from rest: ``steps``
    steps of ``dt`` (T = 2) at tol 1e-8; the norm settles (2e-2 over the last
    100 steps) and the drag is within 1% of the monolithic steady drag
    ``drag_ref`` (examples/test_flow_pass_cylinder.py).  Seconds a step and
    the Krylov iterations of each solve; then ``big_steps`` timed at
    ``big``; then ``matrix_free_mass`` for ``mf_steps`` steps against the
    assembled mass (1e-8)."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.core.function import Function
    from fenicssolver_tpu_torch.solvers.navier_stokes import (
        CoupledNavierStokesSolver,
    )

    res, pts = dfg
    solver = CoupledNavierStokesSolver(dfg_settings(core, res, pts),
                                       device=device)
    _reset_peak(device)
    u, p, n, ks, setup, wall = _ipcs_run(solver, dt, steps, device, tol=1e-8)
    settle = abs(n[-1] - n[-100]) / n[-1]
    W = solver.function_space
    up = Function(W)
    up.values[W.slice_of(0)] = u.cpu().numpy()
    up.values[W.slice_of(1)] = p.cpu().numpy()
    drag, _ = solver.calc_drag_and_lift(up, 0, 1, [4])
    print(f"[ns-ipcs] DFG res {res}/{pts} ({W.ndof} mixed dofs) on "
          f"{u.device}: {steps} steps of {dt}, set-up {setup:.2f} s, "
          f"{wall / steps * 1e3:.2f} ms a step; iterations a step: "
          f"{_iters_text(ks)}; settle {settle:.2e} (tol 2e-2); drag "
          f"{drag:.6g} against the monolithic {drag_ref:.6g} "
          f"({100 * (drag - drag_ref) / drag_ref:+.3f}%)" + _peak_text(device))
    check(np.isfinite(n).all() and settle < 2e-2, f"IPCS settle {settle}")
    check(abs(drag - drag_ref) / abs(drag_ref) < 0.01, f"IPCS drag {drag}")

    u_a, p_a, _, _, _, wall_a = _ipcs_run(solver, dt, mf_steps, device)
    u_m, p_m, _, ks_m, _, wall_m = _ipcs_run(solver, dt, mf_steps, device,
                                             matrix_free_mass=True)
    du = float((u_m - u_a).abs().max() / u_a.abs().max())
    dp = float((p_m - p_a).abs().max() / p_a.abs().max())
    print(f"[ns-ipcs] matrix_free_mass, {mf_steps} steps: "
          f"{wall_m / mf_steps * 1e3:.2f} ms a step against "
          f"{wall_a / mf_steps * 1e3:.2f} ms assembled; max |du| {du:.2e}, "
          f"|dp| {dp:.2e} (tol 1e-8); PCG {ks_m[2].mean():.1f} a step")
    check(du < 1e-8 and dp < 1e-8, "matrix-free mass against the assembled")
    del solver

    bs = CoupledNavierStokesSolver(dfg_settings(core, *big), device=device)
    _reset_peak(device)
    u, _, n, ks, setup, wall = _ipcs_run(bs, dt, big_steps, device, tol=1e-8)
    print(f"[ns-ipcs] DFG res {big[0]}/{big[1]} ({bs.function_space.ndof} "
          f"mixed dofs): set-up {setup:.2f} s, {big_steps} steps "
          f"{wall / big_steps * 1e3:.2f} ms a step; iterations a step: "
          f"{_iters_text(ks)}" + _peak_text(device))
    check(np.isfinite(n).all(), "non-finite IPCS norms at the large mesh")


def elbow_settings(core, res, solving_temperature=False, mesh=None):
    """examples/test_cfd_solver.py's elbow (``setup_case``): rho = 1000, nu
    = 0.5, walls at 320 K and the inlet at 300 K with the temperature; on
    ``mesh``, by default the port's ``elbow_mesh(res)``."""
    from fenicssolver_tpu_torch.core.meshgen import elbow_mesh

    near = core.near
    temp = solving_temperature

    def values(velocity, T):
        v = [{"variable": "velocity", "type": "Dirichlet", "value": velocity}]
        return v + ([{"variable": "temperature", "type": "Dirichlet",
                      "value": T}] if temp else [])

    profile = core.Expression(("0", "max_vel*(1.0-pow((x[0]-0.5)/0.5, 2))"),
                              max_vel=1.0, degree=2)
    return {
        "solver_name": "CoupledNavierStokesSolver",
        "mesh": elbow_mesh(res) if mesh is None else mesh, "fe_degree": 1,
        "boundary_conditions": {
            "walls": {"boundary": core.AutoSubDomain(lambda x: x[0] == x[0]),
                      "boundary_id": 1, "values": values((0.0, 0.0), 320.0)},
            "inlet": {"boundary": core.AutoSubDomain(lambda x: near(x[1], 0.0)),
                      "boundary_id": 2, "values": values(profile, 300.0)},
            "outlet": {"boundary": core.AutoSubDomain(lambda x: near(x[0], 4.0)),
                       "boundary_id": 3, "values": [{
                           "variable": "pressure", "type": "Dirichlet",
                           "value": 0.0}]},
        },
        "body_source": None, "solving_temperature": temp,
        "initial_values": {"velocity": (0.0, 0.0), "pressure": 0.0,
                           "temperature": 300.0},
        "material": {"density": 1000.0, "kinematic_viscosity": 0.5,
                     "specific_heat_capacity": 4200.0,
                     "thermal_conductivity": 0.6},
        "solver_settings": {
            "transient_settings": {"transient": False, "starting_time": 0,
                                   "time_step": 0.1, "ending_time": 1},
            "reference_values": {"temperature": 293, "pressure": 101325},
            "solver_parameters": {"relative_tolerance": 1e-9,
                                  "maximum_iterations": 100,
                                  "monitor_convergence": False},
        },
        "report_settings": dict(QUIET),
    }


def elbow_3d_settings(core, res, mesh=None):
    """examples/test_cfd_solver.py's ``setup_case_3d``: the L-duct
    Box(0,0,0)-(1,2,1) + Box(1,1,0)-(2,2,1), the bi-parabolic inlet at y =
    0, p = 0 at the outlet x = 2, no-slip elsewhere; the 2-D case's material
    and tolerance; on ``mesh``, by default the port's ``elbow_mesh(res,
    three_d=True)``."""
    from fenicssolver_tpu_torch.core.meshgen import elbow_mesh

    near = core.near
    profile = core.Expression(
        ("0", "max_vel*(1.0-pow((x[0]-0.5)/0.5, 2))*(1.0-pow((x[2]-0.5)/0.5, 2))",
         "0"), max_vel=1.0, degree=2)

    def velocity(value):
        return [{"variable": "velocity", "type": "Dirichlet", "value": value}]

    s = elbow_settings(core, res, mesh=(elbow_mesh(res, three_d=True)
                                        if mesh is None else mesh))
    s["boundary_conditions"] = {
        "walls": {"boundary": core.AutoSubDomain(lambda x: x[0] == x[0]),
                  "boundary_id": 1, "values": velocity((0.0, 0.0, 0.0))},
        "inlet": {"boundary": core.AutoSubDomain(lambda x: near(x[1], 0.0)),
                  "boundary_id": 2, "values": velocity(profile)},
        "outlet": {"boundary": core.AutoSubDomain(lambda x: near(x[0], 2.0)),
                   "boundary_id": 3, "values": [{
                       "variable": "pressure", "type": "Dirichlet",
                       "value": 0.0}]},
    }
    s["initial_values"] = {"velocity": (0.0, 0.0, 0.0), "pressure": 0.0}
    return s


def velocity_flux(solver, facet_ids, w, qdeg=4):
    """The integral of u.n over the given exterior facets of ``solver``'s
    mesh (n outward) for the mixed field's values ``w`` (a tensor on the
    solver's device), by ``assembly.assemble_functional``: the kernel of
    tests/test_ns_dg.py and examples/test_cfd_solver.py.  A 0-d tensor on
    the solver's device."""
    import torch

    from fenicssolver_tpu_torch.ops import assembly, geometry

    W = solver.function_space
    d = solver.mesh.gdim
    Vv = W.subspaces[0]
    kv = Vv.scalar_space.ndof_el
    fctx = geometry.build_facet_context(W, facet_ids, qdeg, device=w.device,
                                        dtype=w.dtype)
    fphi, _, fw, _ = geometry.facet_basis_tables(solver.mesh.tdim, Vv.degree,
                                                 qdeg)
    fphi = torch.as_tensor(fphi, dtype=w.dtype, device=w.device)
    fw = torch.as_tensor(fw, dtype=w.dtype, device=w.device)

    def kern(we, geom, aux):
        U = we[: kv * d].reshape(kv, d)
        uq = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0] @ U
        return torch.sum(fw * geom.detF * (uq @ geom.normal))

    return assembly.assemble_functional(kern, fctx, u=w)


def fixed_flux(solver, facet_ids):
    """``velocity_flux`` of the solver's result over ``facet_ids`` as a
    float; fails unless two calls give the same bits."""
    import torch

    w = torch.as_tensor(solver.result.values, dtype=solver.dtype,
                        device=solver.device)
    a, b = velocity_flux(solver, facet_ids, w), velocity_flux(solver, facet_ids, w)
    check(torch.equal(a, b), "two calls of assemble_functional differ")
    return float(a)


def elbow_balance(solver):
    """(q_in, q_out): the flux u.n through the elbow's inlet (boundary 2)
    and outlet (3)."""
    return tuple(fixed_flux(solver, solver.boundary_facet_ids(b)) for b in (2, 3))


def _check_elbow(name, solver, q_in, q_out):
    """examples/test_cfd_solver.py's checks: finite, |u| < 3 max_vel, the
    inflow in, the outflow out and within 2% of it."""
    import numpy as np

    u = solver.split_solution()[0].values
    umax = float(np.abs(u).max())
    check(np.isfinite(solver.result.values).all() and umax < 3.0,
          f"{name}: |u|max {umax}")
    check(q_in < 0.0 < q_out and abs(q_out + q_in) / abs(q_in) < 0.02,
          f"{name}: q_in {q_in}, q_out {q_out}")
    return umax


def _newton_routes(solver):
    return [st["route"] for st in solver.last_newton]


def run_elbow(name, res, settings, device):
    """One elbow through ``main(settings)`` with the example's checks; one
    line: cells, dofs, seconds, Newton steps and their routes, the fluxes."""
    from fenicssolver_tpu_torch.main import main as run_main

    t0 = time.perf_counter()
    flow = run_main(settings, device=device)
    wall = time.perf_counter() - t0
    q_in, q_out = elbow_balance(flow)
    umax = _check_elbow(name, flow, q_in, q_out)
    print(f"[ns-coupled] {name} res {res}: {flow.mesh.num_cells()} cells, "
          f"{flow.function_space.ndof} dofs on {flow.device}, main() "
          f"{wall:.2f} s, {flow.last_iterations} Newton steps, routes "
          f"{_newton_routes(flow)}, outer iterations "
          f"{[st['iterations'] for st in flow.last_newton]}; |u|max "
          f"{umax:.4f}; q_in {q_in:.6f}, q_out {q_out:.6f}, |q_out + q_in| / "
          f"|q_in| {abs(q_out + q_in) / abs(q_in):.2e} (tol 0.02)")
    return flow


def phase_ns_coupled(device=None, res=7, res_flow=8, res_3d=5):
    """The elbow of examples/test_cfd_solver.py through ``main(settings)``:
    the 2-D flow at ``res_flow`` and the 3-D elbow of ``setup_case_3d`` at
    ``res_3d`` (5: 2,250 cells, 11,829 Taylor-Hood dofs, the example's
    size), each with the example's checks (finite, |u| < 3, the outflow
    within 2% of the inflow, by ``assemble_functional`` twice bit-equal);
    the coupled temperature (295 < T < 321.5) at ``res``."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    run_elbow("elbow", res_flow, elbow_settings(core, res_flow), device)
    t0 = time.perf_counter()
    run_elbow("3-D elbow", res_3d, elbow_3d_settings(core, res_3d), device)
    print(f"[ns-coupled] the 3-D elbow from its settings to its checks: "
          f"{time.perf_counter() - t0:.3f} s")
    t1 = time.perf_counter()
    coupled = run_main(elbow_settings(core, res, True), device=device)
    t2 = time.perf_counter()
    T = coupled.result.values[coupled.function_space.slice_of(2)]
    print(f"[ns-coupled] elbow with temperature res {res}: "
          f"{coupled.function_space.ndof} dofs on {coupled.device}, "
          f"{t2 - t1:.2f} s, {coupled.last_iterations} Newton steps, T in "
          f"[{T.min():.3f}, {T.max():.3f}]")
    check(np.isfinite(T).all() and 295.0 < T.min() and T.max() < 321.5,
          f"elbow T range [{T.min()}, {T.max()}]")


def phase_elbow_3d_large(device=None, res=12):
    """The 3-D elbow at ``res`` (12: 31,104 cells, 143,128 dofs) through
    ``main(settings)``, past ``la.direct.DENSE_LIMIT``, so every Newton
    update takes the iterative saddle-point route (``fieldsplit`` FGMRES
    with the momentum AMG); the example's checks.  Only under ``--only
    elbow-3d``, so that the default run keeps inside its time limit."""
    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la import direct

    flow = run_elbow("3-D elbow", res, elbow_3d_settings(core, res), device)
    check(flow.function_space.ndof > direct.DENSE_LIMIT
          and all(r != "dense" for r in _newton_routes(flow)),
          f"the 3-D elbow at res {res} took {_newton_routes(flow)}")
    print(f"[elbow-3d] {_ns_timers(flow)}")


def fsi_channel(core):
    """tests/test_fsi.py's ``make_fsi_settings``: a channel (8 x 4, y in
    [0.5, 1]) over an elastic slab (8 x 2, y in [0.3, 0.5]), rho = 1000, E =
    1e6, three steps of 0.02."""
    near = core.near
    transient = {"transient": True, "starting_time": 0.0, "time_step": 0.02,
                 "ending_time": 0.06}
    parabola = core.Expression(("umax*16.0*(x[1]-0.5)*(1.0-x[1])", "0"),
                               umax=0.3, degree=2)
    interface = core.AutoSubDomain(lambda x: near(x[1], 0.5))

    def bc(bid, pred, value, variable="velocity"):
        return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
                "values": [{"variable": variable, "type": "Dirichlet",
                            "value": value}]}

    fluid_bcs = {
        "inlet": bc(1, lambda x: near(x[0], 0.0), parabola),
        "outlet": bc(2, lambda x: near(x[0], 1.0), 0.0, "pressure"),
        "top": bc(3, lambda x: near(x[1], 1.0), (0.0, 0.0)),
        "interface": {"boundary": interface, "boundary_id": 4,
                      "coupling": "FSI"},
    }
    zero = core.Constant((0.0, 0.0))
    solid_bcs = {
        "bottom": {"boundary": core.AutoSubDomain(lambda x: near(x[1], 0.3)),
                   "boundary_id": 1, "type": "Dirichlet", "value": zero},
        "sides": {"boundary": core.AutoSubDomain(
            lambda x: near(x[0], 0.0) | near(x[0], 1.0)), "boundary_id": 2,
            "type": "Dirichlet", "value": zero},
        "interface": {"boundary": interface, "boundary_id": 4,
                      "coupling": "FSI", "type": "stress", "value": zero},
    }
    return _fsi_settings(
        _fsi_fluid(core.RectangleMesh(core.Point(0, 0.5), core.Point(1, 1.0), 8,
                                      4), fluid_bcs, 1000.0, 0.01, 0.0,
                   transient, 1e-9),
        _fsi_solid(core.RectangleMesh(core.Point(0, 0.3), core.Point(1, 0.5), 8,
                                      2), solid_bcs, 1e6, 0.3, 2e-6, transient),
        transient)


def _fsi_fluid(mesh, bcs, rho, nu, p0, transient, rtol):
    return {
        "solver_name": "CoupledNavierStokesSolver", "mesh": mesh,
        "fe_degree": 1, "boundary_conditions": bcs, "body_source": None,
        "initial_values": {"velocity": (0.0, 0.0), "pressure": p0},
        "material": {"density": rho, "kinematic_viscosity": nu},
        "solver_settings": {
            "transient_settings": transient,
            "reference_values": {"pressure": 101325.0},
            "solver_parameters": {"relative_tolerance": rtol,
                                  "maximum_iterations": 100,
                                  "monitor_convergence": False}},
        "report_settings": dict(QUIET),
    }


def _fsi_solid(mesh, bcs, E, nu, alpha, transient,
               solver_name="LinearElasticitySolver", density=1000):
    material = {"elastic_modulus": E, "poisson_ratio": nu, "density": density}
    s = {
        "solver_name": solver_name, "mesh": mesh, "fe_degree": 2,
        "boundary_conditions": bcs, "material": material,
        "solver_settings": {
            "transient_settings": transient,
            "reference_values": {"temperature": 293},
            "solver_parameters": {"relative_tolerance": 1e-10,
                                  "maximum_iterations": 2000,
                                  "monitor_convergence": False}},
        "report_settings": dict(QUIET),
    }
    if solver_name == "LinearElasticitySolver":
        s["temperature_distribution"] = None
        material["thermal_expansion_coefficient"] = alpha
    return s


def _fsi_settings(fluid, solid, transient):
    return {"solver_name": "FSISolver",
            "participants": [{"solver_domain": "fluidic", "settings": fluid},
                             {"solver_domain": "elastic", "settings": solid}],
            "parent_mesh": None, "transient_settings": transient,
            "coupling_settings": {}}


#: the pressure-loaded cantilever of tests/test_fsi.py: length, thickness,
#: fluid pressure and the beam's modulus
CANT_L, CANT_T, CANT_P0, CANT_E = 1.0, 0.1, 50.0, 1e7


def fsi_cantilever(core, scale=1, solid="LinearElasticitySolver"):
    """tests/test_fsi.py's pressure-loaded cantilever: a static fluid at p0
    over a clamped beam, fluid ``(10, 4) * scale`` P2/P1, solid ``(20, 2) *
    scale`` P2, three steps of 0.2 (four with the large-deformation solid,
    nu = 0.3, density 10; else nu = 0)."""
    near = core.near
    L, t, p0 = CANT_L, CANT_T, CANT_P0
    large = solid == "LargeDeformationSolver"
    transient = {"transient": True, "starting_time": 0.0, "time_step": 0.2,
                 "ending_time": 0.8 if large else 0.6}
    interface = core.AutoSubDomain(lambda x: near(x[1], t))

    def bc(bid, pred, value, variable="velocity"):
        return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
                "values": [{"variable": variable, "type": "Dirichlet",
                            "value": value}]}

    fluid_bcs = {
        "inlet": bc(1, lambda x: near(x[0], 0.0), p0, "pressure"),
        "outlet": bc(2, lambda x: near(x[0], L), p0, "pressure"),
        "top": bc(3, lambda x: near(x[1], 0.4), (0.0, 0.0)),
        "interface": {"boundary": interface, "boundary_id": 4,
                      "coupling": "FSI"},
    }
    zero = core.Constant((0.0, 0.0))
    solid_bcs = {
        "clamp": {"boundary": core.AutoSubDomain(lambda x: near(x[0], 0.0)),
                  "boundary_id": 1, "type": "Dirichlet", "value": zero},
        "interface": {"boundary": interface, "boundary_id": 4,
                      "coupling": "FSI", "type": "stress", "value": zero},
    }
    fluid = _fsi_fluid(core.RectangleMesh(core.Point(0, t), core.Point(L, 0.4),
                                          10 * scale, 4 * scale),
                       fluid_bcs, 1.0, 0.1, p0, transient, 1e-10)
    solid_s = _fsi_solid(
        core.RectangleMesh(core.Point(0, 0.0), core.Point(L, t), 20 * scale,
                           2 * scale), solid_bcs, CANT_E, 0.3 if large else 0.0,
        0.0, transient, solid, 10.0 if large else 1000)
    solid_s["solver_settings"]["solver_parameters"].update(
        relative_tolerance=1e-10 if large else 1e-12,
        maximum_iterations=50 if large else 4000)
    return _fsi_settings(fluid, solid_s, transient)


def cantilever_tip(fsi, average=False):
    """(the tip deflection, Euler-Bernoulli's q L^4 / (8 E I)): the solid's
    vertical displacement at (L, t/2), with the plane-strain modulus for
    nu = 0.3; ``average``: the mean of the last two steps (the
    large-deformation solid's undamped ringing)."""
    import numpy as np

    solid = fsi.solid_solver
    W = solid.function_space
    large = getattr(W, "subspaces", None) is not None
    V = W.subspaces[0] if large else W
    su = W.slice_of(0) if large else slice(None)
    U = solid.w_current.values[su].reshape(-1, 2)
    if average:
        U = 0.5 * (U + solid.w_prev.values[su].reshape(-1, 2))
    X = V.scalar_space.dof_coords
    tip = np.argmin((X[:, 0] - CANT_L) ** 2 + (X[:, 1] - CANT_T / 2) ** 2)
    E_eff = CANT_E / (1.0 - 0.3**2) if large else CANT_E
    w_exact = -CANT_P0 * CANT_L**4 / (8.0 * E_eff * CANT_T**3 / 12.0)
    return float(U[tip, 1]), w_exact


def fsi_snapshots(fsi):
    """Run ``fsi.solve()`` (either package's FSISolver) and keep after every
    step the fluid's ``up``, the solid's ``u``, the fluid mesh's vertices,
    the last mesh displacement, each participant's history and the time the
    step started at."""
    import numpy as np

    snaps = []
    step = fsi.solve_current_step

    def recorded():
        step()
        f, s = fsi.fluid_solver, fsi.solid_solver
        snaps.append(dict(
            up=np.array(f.w_current.values), u=np.array(s.w_current.values),
            coords=f.mesh.coords.copy(),
            mesh_disp=np.array(fsi.previous_fluid_mesh_disp),
            fluid=tuple(np.array(w.values) for w in (f.w_current, f.w_prev,
                                                     f.w_pp)),
            solid=tuple(np.array(w.values) for w in (s.w_current, s.w_prev,
                                                     s.w_pp)),
            time=fsi.current_time))

    fsi.solve_current_step = recorded
    fsi.solve()
    return snaps


def check_dg_fieldsplit(solver):
    """An NSDGSolver solve beyond the dense limit: the DG p-multigrid
    hierarchy was built (a set-up that throws leaves None, the diagonal
    fallback, ~20x the outer iterations), and every Newton update took the
    ``fieldsplit`` route (no ``splu_after_stall``)."""
    cache = getattr(solver, "_mom_amg_cache", None)
    check(cache is not None and cache["amg"] is not None,
          "the DG p-multigrid hierarchy is None: the momentum preconditioner "
          "fell back to the diagonal")
    routes = [st["route"] for st in solver.last_newton]
    check(routes and set(routes) == {"fieldsplit"},
          f"a Newton update left the fieldsplit route: {routes}")


#: the 3-D Couette duct's outer budget: at the reference's FGMRES(120) x 8
#: the fieldsplit updates at 8^3 end at 960 outer, one of four above rel res
#: 1e-2 (SuperLU then took 639 s on the H100); unrestarted, they need ~150
#: at 6^3 (227-237 restarted at 120, the CPU)
DG_COUETTE_BUDGET = (400, 3)


def dg_flow_settings(core, nx, ny=None, transient=False):
    """examples/test_dg_flow.py's ``settings``: the Poiseuille channel on
    the DG2/DG1 pair (U = 0.3, nu = 0.05, rho = 1000), rtol 1e-10; with
    ``transient``, the impulsive start-up: backward Euler of 0.25 to 3.0."""
    s = ns_channel(core, nx, ny)
    s["solver_name"] = "NSDGSolver"
    s["solver_settings"]["transient_settings"] = {
        "transient": transient, "starting_time": 0.0, "time_step": 0.25,
        "ending_time": 3.0}
    s["solver_settings"]["solver_parameters"].update(
        relative_tolerance=1e-10, maximum_iterations=50)
    return s


def dg_couette(core, n):
    """tests/test_ns_dg.py's 3-D Couette duct on ``UnitCubeMesh(n)``: u =
    (y, 0, 0), p = 0, exact in DG2; weak Dirichlet at the inlet and the
    walls, the do-nothing outflow, spanwise symmetry planes."""
    near = core.near

    def bc(bid, pred, value, variable="velocity", btype="Dirichlet"):
        return {"boundary": core.AutoSubDomain(pred), "boundary_id": bid,
                "values": [{"variable": variable, "type": btype,
                            "value": value}]}

    s = ns_channel(core, 2)
    s.update(solver_name="NSDGSolver", mesh=core.UnitCubeMesh(n, n, n),
             material={"density": 1.0, "kinematic_viscosity": 0.5},
             initial_values={"velocity": (0.0, 0.0, 0.0), "pressure": 0.0})
    s["boundary_conditions"] = {
        "inlet": bc(1, lambda x: near(x[0], 0.0),
                    core.Expression(("x[1]", "0", "0"), degree=1)),
        "outlet": bc(2, lambda x: near(x[0], 1.0), 0.0, "pressure"),
        "bottom": bc(3, lambda x: near(x[1], 0.0), (0.0, 0.0, 0.0)),
        "top": bc(4, lambda x: near(x[1], 1.0), (1.0, 0.0, 0.0)),
        "span": bc(5, lambda x: near(x[2], 0.0) or near(x[2], 1.0), None,
                   btype="symmetry"),
    }
    return s


def _dg_velocity_error(solver, exact):
    """rel-L2 of the DG velocity against ``exact(X)`` at its nodes."""
    W = solver.function_space
    u = solver.result.values[W.slice_of(0)].reshape(-1, solver.mesh.gdim)
    return _rel_l2(u, exact(W.subspaces[0].scalar_space.dof_coords))


def _poiseuille_field(X):
    import numpy as np

    return np.stack([4 * 0.3 * X[:, 1] * (1 - X[:, 1]), 0 * X[:, 0]], 1)


def _couette_field(X):
    import numpy as np

    return np.stack([X[:, 1], 0 * X[:, 0], 0 * X[:, 0]], 1)


class PeakParts:
    """While active on the card: the peak device memory of each part of a
    solve, reset at each part's start and read at its end.  The parts: each
    term of a Jacobian assembly (``ops/assembly.assemble_jacobian``; the
    term's context kind, element size k, batch and chunk), a residual
    assembly, ``NSDGSolver._build_pmg``, the outer ``la/krylov.fgmres``, and
    "other" (what runs between them).  ``peaks``: {part: bytes};
    ``terms``: {part: (batch, k, cells a chunk)}."""

    def __init__(self, device):
        self.on = _on_card(device)
        self.peaks, self.terms = {}, {}
        self.current, self.depth, self.jacobian = "other", 0, False

    def _mark(self, name):
        import torch

        if self.on:
            torch.cuda.synchronize()
            p = torch.cuda.max_memory_allocated()
            self.peaks[self.current] = max(self.peaks.get(self.current, 0), p)
            torch.cuda.reset_peak_memory_stats()
        self.current = name

    def _wrap(self, owner, attr, name, jacobian=False):
        fn = getattr(owner, attr)

        def run(*args, **kw):
            if self.depth:
                return fn(*args, **kw)
            self.depth, self.jacobian = 1, jacobian
            self._mark(name)
            try:
                return fn(*args, **kw)
            finally:
                self._mark("other")
                self.depth, self.jacobian = 0, False

        self.saved.append((owner, attr, fn))
        setattr(owner, attr, run)

    def __enter__(self):
        from fenicssolver_tpu_torch.la import krylov
        from fenicssolver_tpu_torch.ops import assembly
        from fenicssolver_tpu_torch.solvers.navier_stokes_dg import NSDGSolver

        self.saved = []
        scatters = assembly._scatters

        def each_term(term):
            if self.jacobian:
                kind = type(term.ctx).__name__.replace("Context", "")
                batch, k = term.ctx.cell_dofs.shape
                name = f"jacobian {kind} k={k}"
                self.terms[name] = (int(batch), int(k),
                                    assembly._chunk_size(term))
                self._mark(name)
            return scatters(term)

        self.saved.append((assembly, "_scatters", scatters))
        assembly._scatters = each_term
        self._wrap(assembly, "assemble_jacobian", "jacobian", jacobian=True)
        self._wrap(assembly, "assemble_residual", "residual")
        self._wrap(NSDGSolver, "_build_pmg", "_build_pmg")
        self._wrap(krylov, "fgmres", "fgmres")
        self._mark("other")
        return self

    def __exit__(self, *exc):
        self._mark("other")
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)

    def lines(self, tag, what):
        from fenicssolver_tpu_torch.ops import assembly

        out = []
        for name, b in sorted(self.peaks.items(), key=lambda kv: -kv[1]):
            extra = ""
            if name in self.terms:
                batch, k, chunk = self.terms[name]
                model = min(chunk, batch) * k * k * assembly.JACFWD_BYTES_PER_ENTRY
                extra = (f": {batch} in the batch, {chunk} a chunk, the chunk "
                         f"model's {model / 2**30:.2f} GiB for a chunk "
                         f"({b / max(model, 1):.1f}x)")
            out.append(f"[{tag}] {what} peak of {name}: {b / 2**30:.2f} GiB"
                       + extra)
        return out


def couette_run(core, run_main, device, n):
    """The 3-D Couette duct at ``n`` through ``main()`` with
    ``DG_COUETTE_BUDGET``, its peak memory split by ``PeakParts``: (solver,
    wall seconds, the ``PeakParts``)."""
    s = dg_couette(core, n)
    s["solver_settings"]["solver_parameters"].update(
        gmres_restart=DG_COUETTE_BUDGET[0], gmres_maxiter=DG_COUETTE_BUDGET[1])
    _reset_peak(device)
    t0 = time.perf_counter()
    with PeakParts(device) as parts:
        duct = run_main(s, device=device)
    return duct, time.perf_counter() - t0, parts


def phase_ns_dg(device=None, n=64, n_couette=8, startup=(6, 5),
                couette_small=6):
    """NSDGSolver through ``main(settings)`` on the default device: the
    steady DG2/DG1 Poiseuille channel of examples/test_dg_flow.py on
    ``UnitSquareMesh(n)`` (n = 64: 8,192 cells, 122,880 dofs), every Newton
    update on ``fieldsplit`` with the DG p-multigrid present
    (``check_dg_fieldsplit``), the velocity within 1e-8 of the parabola;
    one outer iteration's wall and device time and two solves of one
    system (equal outer counts, bit-equal); the 3-D Couette duct on
    ``UnitCubeMesh(n_couette)`` (n = 8: 3,072 cells, 104,448 dofs), exact
    to 1e-8, with its peak device memory by part (``PeakParts``) at
    ``couette_small`` and ``n_couette``; the example's transient start-up
    at ``startup``, the card against the port on the CPU (1e-9) and within
    the example's 2e-3."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    _reset_peak(device)
    t0 = time.perf_counter()
    solver = run_main(dg_flow_settings(core, n), device=device)
    wall = time.perf_counter() - t0
    if _on_card(device):
        check(solver.device.type == "cuda", f"the DG channel ran on {solver.device}")
    err = _dg_velocity_error(solver, _poiseuille_field)
    outer = [st["iterations"] for st in solver.last_newton]
    print(f"[ns-dg] DG2/DG1 channel {n} x {n}: {solver.mesh.num_cells()} cells, "
          f"{solver.function_space.ndof} dofs on {solver.device}: main() "
          f"{wall:.2f} s, {solver.last_iterations} Newton steps, outer "
          f"iterations {outer}; {_ns_timers(solver)}; velocity rel-L2 against "
          f"the parabola {err:.2e} (tol 1e-8)" + _peak_text(device))
    _ns_newton_lines("ns-dg", solver)
    check_dg_fieldsplit(solver)
    check(err <= 1e-8, f"DG channel velocity error {err}")
    t0 = time.perf_counter()
    flux = fixed_flux(solver, solver.mesh.exterior_facets())
    t_flux = time.perf_counter() - t0
    inflow = 4 * 0.3 / 6  # the integral of the parabola, U = 0.3
    print(f"[ns-dg] net boundary flux of the channel by assemble_functional: "
          f"{flux:.3e}, {abs(flux) / inflow:.2e} of the inflow {inflow:.4f} "
          f"(tol 1e-8), two calls bit-equal in {t_flux:.3f} s")
    check(abs(flux) < 1e-8 * inflow, f"DG channel net boundary flux {flux}")
    wall_it, dev, (it1, it2, same, r1) = profile_fgmres_iteration(solver)
    print(f"[ns-dg] one FGMRES outer iteration at the solution: {wall_it:.3f} "
          f"ms wall, {dev}; two solves from zero: {it1} and {it2} outer "
          f"(rel res {r1:.1e}), bit-equal {same}")
    check(it1 == it2 and same, "two DG FGMRES solves of one system differ")
    del solver

    if _on_card(device):  # the Couette's peak by part, at two sizes
        small, wall, parts = couette_run(core, run_main, device, couette_small)
        print(f"[ns-dg] 3-D Couette UnitCubeMesh({couette_small}): "
              f"{small.function_space.ndof} dofs, main() {wall:.2f} s, outer "
              f"{[st['iterations'] for st in small.last_newton]}; peak "
              f"{max(parts.peaks.values()) / 2**30:.2f} GiB")
        print("\n".join(parts.lines("ns-dg", f"Couette {couette_small}^3")))
        del small
    duct, wall, parts = couette_run(core, run_main, device, n_couette)
    err = _dg_velocity_error(duct, _couette_field)
    pmax = float(np.abs(duct.result.values[duct.function_space.slice_of(1)]).max())
    print(f"[ns-dg] 3-D Couette UnitCubeMesh({n_couette}): "
          f"{duct.mesh.num_cells()} cells, {duct.function_space.ndof} dofs: "
          f"main() {wall:.2f} s, {duct.last_iterations} Newton steps, outer "
          f"{[st['iterations'] for st in duct.last_newton]}; {_ns_timers(duct)}; "
          f"velocity rel-L2 {err:.2e}, max|p| {pmax:.1e}"
          + (f"; peak {max(parts.peaks.values()) / 2**30:.2f} GiB"
             if _on_card(device) else ""))
    if _on_card(device):
        print("\n".join(parts.lines("ns-dg", f"Couette {n_couette}^3")))
    check_dg_fieldsplit(duct)
    check(err <= 1e-8 and pmax < 1e-6, f"Couette error {err}, max|p| {pmax}")
    del duct

    out = {}
    for where in (device, "cpu"):
        t0 = time.perf_counter()
        s = run_main(dg_flow_settings(core, *startup, transient=True),
                     device=where)
        out[where] = (s.result.values.copy(), time.perf_counter() - t0,
                      s.steps_taken, _dg_velocity_error(s, _poiseuille_field))
    rel = _rel_l2(out[device][0], out["cpu"][0])
    print(f"[ns-dg] transient start-up {startup[0]} x {startup[1]}, "
          f"{out['cpu'][2]} steps: {out[device][1]:.2f} s on the card, "
          f"{out['cpu'][1]:.2f} s on the cpu; rel-L2 {rel:.2e} (tol 1e-9); "
          f"against the parabola {out[device][3]:.2e} (tol 2e-3)")
    check(rel <= 1e-9, f"DG start-up card vs CPU {rel}")
    check(out[device][3] < 2e-3, f"DG start-up error {out[device][3]}")


def pulse_settings(core, n, t_end=0.25):
    """examples/test_compressible_flow.py's acoustic pulse: a Gaussian
    bump of 0.01 on p = 1 (rho = 1, gamma = 1.4, R = T = 1) in the slip-wall
    unit square, CFL 0.3."""
    import numpy as np

    def side(ax, w):
        return lambda x: core.near(x[ax], w)

    bcs = {f"wall{i}": {"boundary": core.AutoSubDomain(side(ax, w)),
                        "boundary_id": i + 1, "type": "symmetry"}
           for i, (ax, w) in enumerate([(0, 0.0), (0, 1.0), (1, 0.0), (1, 1.0)])}
    return {
        "solver_name": "CompressibleNSSolver", "mesh": core.UnitSquareMesh(n),
        "boundary_conditions": bcs,
        "initial_values": {
            "pressure": lambda x: 1.0 + 0.01 * np.exp(
                -200.0 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2)),
            "temperature": 1.0},
        "material": {"specific_heat_ratio": 1.4, "gas_constant": 1.0},
        "solver_settings": {
            "transient_settings": {"transient": True, "starting_time": 0.0,
                                   "ending_time": t_end, "cfl": 0.3},
            "reference_values": {}, "solver_parameters": {}},
        "report_settings": dict(QUIET),
    }


def _pulse_vectorised(s):
    """The pulse's initial pressure as a nodal array on the settings' mesh
    (the callable is evaluated node by node, ~1 s a million nodes on the
    host)."""
    import numpy as np

    X = s["mesh"].coords
    s["initial_values"]["pressure"] = 1.0 + 0.01 * np.exp(
        -200.0 * ((X[:, 0] - 0.5) ** 2 + (X[:, 1] - 0.5) ** 2))
    return s


def compressible_settings(core, mesh, bcs, t_end, material, initial, cfl=0.3,
                          **solver):
    """tests/test_compressible.py's ``base_settings``: an explicit march to
    ``t_end`` at ``cfl`` (``solver`` goes into ``solver_settings``, e.g.
    ``artificial_viscosity``)."""
    return {
        "solver_name": "CompressibleNSSolver", "mesh": mesh,
        "boundary_conditions": bcs, "initial_values": initial or {},
        "material": material or {},
        "solver_settings": dict({
            "transient_settings": {"transient": True, "starting_time": 0.0,
                                   "ending_time": t_end, "cfl": cfl},
            "reference_values": {}, "solver_parameters": {}}, **solver),
        "report_settings": {"plotting_freq": 0, "saving_freq": 0,
                            "logging_level": 40},
    }


def walls(core, dim, kind="symmetry"):
    """Every side of the unit interval, square or cube: slip walls, or
    no-slip (velocity Dirichlet) walls."""
    def side(ax, w):
        return lambda x: core.near(x[ax], w)

    bcs = {}
    for i, (ax, w) in enumerate((ax, w) for ax in range(dim) for w in (0.0, 1.0)):
        bc = {"boundary": core.AutoSubDomain(side(ax, w)), "boundary_id": i + 1}
        if kind == "symmetry":
            bc["type"] = "symmetry"
        else:
            bc["values"] = [{"variable": "velocity", "type": "Dirichlet",
                             "value": (0.0,) * dim}]
        bcs[f"w{i}"] = bc
    return bcs


GAS = {"specific_heat_ratio": 1.4, "gas_constant": 1.0}


def box_settings(core, n=12, t_end=0.25):
    """tests/test_compressible.py's closed box: a pressure bump of 0.2
    sloshing between slip walls on ``UnitSquareMesh(n)``."""
    import numpy as np

    def bump(x):
        return 1.0 + 0.2 * np.exp(-40.0 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2))

    return compressible_settings(core, core.UnitSquareMesh(n), walls(core, 2),
                                 t_end, dict(GAS),
                                 {"pressure": bump, "temperature": 1.0})


def sod_settings(core, n=400):
    """tests/test_compressible.py's Sod tube: (1, 1) | (0.125, 0.1) at x =
    0.5 (R = 1), walls at both ends, artificial viscosity 1, CFL 0.25, to
    t = 0.2."""
    return compressible_settings(
        core, core.IntervalMesh(n, 0.0, 1.0), walls(core, 1, "noslip"), 0.2,
        dict(GAS), {"pressure": lambda x: 1.0 if x[0] < 0.5 else 0.1,
                    "temperature": lambda x: 1.0 if x[0] < 0.5 else 0.8},
        cfl=0.25, artificial_viscosity=1.0)


def sod_exact(x, t, gamma=1.4, x0=0.5):
    """The exact Riemann solution of Sod's tube (Toro ch. 4): (rho, u, p)
    at the points x and time t."""
    import numpy as np

    rl, pl, ul, rr, pr, ur = 1.0, 1.0, 0.0, 0.125, 0.1, 0.0
    cl, cr = np.sqrt(gamma * pl / rl), np.sqrt(gamma * pr / rr)
    g1 = (gamma - 1.0) / (2.0 * gamma)
    g2 = (gamma + 1.0) / (2.0 * gamma)

    def f(p, rho_k, p_k, c_k):
        if p > p_k:  # a shock
            A = 2.0 / ((gamma + 1.0) * rho_k)
            B = (gamma - 1.0) / (gamma + 1.0) * p_k
            return (p - p_k) * np.sqrt(A / (p + B))
        return (2.0 * c_k / (gamma - 1.0)) * ((p / p_k) ** g1 - 1.0)

    p_lo, p_hi = 1e-8, 2.0  # bisection for the star pressure
    for _ in range(200):
        pm = 0.5 * (p_lo + p_hi)
        if f(pm, rl, pl, cl) + f(pm, rr, pr, cr) + (ur - ul) > 0:
            p_hi = pm
        else:
            p_lo = pm
    ps = 0.5 * (p_lo + p_hi)
    us = 0.5 * (ul + ur) + 0.5 * (f(ps, rr, pr, cr) - f(ps, rl, pl, cl))
    rsl = rl * (ps / pl) ** (1.0 / gamma)
    csl = np.sqrt(gamma * ps / rsl)
    k = (gamma - 1.0) / (gamma + 1.0)
    rsr = rr * ((ps / pr + k) / (k * ps / pr + 1.0))
    s_shock = ur + cr * np.sqrt(g2 * ps / pr + g1)
    xi = (np.asarray(x) - x0) / t
    rho, u, p = (np.empty_like(xi) for _ in range(3))
    head, tail = ul - cl, us - csl
    for i, sv in enumerate(xi):
        if sv < head:
            rho[i], u[i], p[i] = rl, ul, pl
        elif sv < tail:  # inside the rarefaction fan
            u[i] = 2.0 / (gamma + 1.0) * (cl + 0.5 * (gamma - 1.0) * ul + sv)
            c = cl - 0.5 * (gamma - 1.0) * (u[i] - ul)
            rho[i] = rl * (c / cl) ** (2.0 / (gamma - 1.0))
            p[i] = pl * (c / cl) ** (2.0 * gamma / (gamma - 1.0))
        elif sv < us:
            rho[i], u[i], p[i] = rsl, us, ps
        elif sv < s_shock:
            rho[i], u[i], p[i] = rsr, us, ps
        else:
            rho[i], u[i], p[i] = rr, ur, pr
    return rho, u, p


def profile_step(solver, steps=20, top=5):
    """One SSP-RK2 step of a prepared ``CompressibleNSSolver`` from its
    final state: the wall ms a step over ``steps`` (synchronised), and from
    ``torch.profiler`` over one step the device-busy ms, the idle share, the
    device events and the ``top`` kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = solver.step_function(solver.last_dt)
    U = torch.as_tensor(solver.state, dtype=solver.dtype, device=solver.device)
    step(U)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        U = step(U)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(U)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (f"one step: {wall:.3f} ms wall, device busy {busy:.3f} ms "
            f"({len(dev)} device events), idle {100 * (1 - busy / wall):.1f}%; "
            "heaviest: " + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms"
                                     for name, us in heavy))


def phase_compressible(device=None, n=1024, n_sod=400, n_check=12):
    """CompressibleNSSolver through ``main(settings)`` on the default
    device: the acoustic pulse of examples/test_compressible_flow.py on
    ``UnitSquareMesh(n)`` (n = 1024: 1,050,625 nodes, 2,097,152 cells),
    mass and total energy conserved to 1e-12, the front within 10% of c t;
    Sod's tube of tests/test_compressible.py at ``n_sod`` to the test's
    bounds; the closed box of tests/test_compressible.py at ``n_check``,
    the card against the CPU (1e-12) and two marches bit-equal."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main
    _reset_peak(device)
    t0 = time.perf_counter()
    solver = run_main(_pulse_vectorised(pulse_settings(core, n)), device=device)
    wall = time.perf_counter() - t0
    march = solver.timers.totals["march"]
    ml = solver._tables["mlump"].cpu().numpy()
    tot0 = (solver._initial_state() * ml[None, :]).sum(axis=1)
    tot1 = solver.totals()
    dm = abs(tot1[0] - tot0[0]) / tot0[0]
    dE = abs(tot1[-1] - tot0[-1]) / abs(tot0[-1])
    X = solver.mesh.coords
    line = np.isclose(X[:, 1], 0.5) & (X[:, 0] > 0.55)
    dp = np.abs(solver._pressure_np()[line] - 1.0)
    r_front = abs(X[line, 0][np.argmax(dp)] - 0.5)
    r_exact = np.sqrt(1.4) * 0.25
    print(f"[compressible] acoustic pulse {n} x {n}: {solver.function_space.ndof} "
          f"nodes, {solver.mesh.num_cells()} cells on {solver.device}: main() "
          f"{wall:.2f} s, {solver.steps_taken} SSP-RK2 steps of "
          f"{solver.last_dt:.3e}, march {march:.2f} s, "
          f"{march / solver.steps_taken * 1e3:.3f} ms a step; d(mass)/mass "
          f"{dm:.2e}, d(E)/E {dE:.2e} (tol 1e-12); front radius {r_front:.4f} "
          f"against c t = {r_exact:.4f}" + _peak_text(device))
    check(dm < 1e-12 and dE < 1e-12, f"pulse conservation {dm}, {dE}")
    check(abs(r_front - r_exact) / r_exact < 0.10, f"front radius {r_front}")
    if _on_card(device):
        print("[compressible] " + profile_step(solver))
    del solver

    sod = run_main(sod_settings(core, n_sod), device=device)
    xs = sod.mesh.coords[:, 0]
    rho = sod.state[0]
    l1 = float(np.abs(rho - sod_exact(xs, 0.2)[0]).mean())
    plateau = float(rho[(xs > 0.75) & (xs < 0.82)].mean())
    pmin = float(sod._pressure_np().min())
    print(f"[compressible] Sod n = {n_sod}: {sod.steps_taken} steps, march "
          f"{sod.timers.totals['march']:.2f} s; density L1 {l1:.4f} (tol "
          f"0.04), plateau {plateau:.4f} (0.2656 +- 0.02), min p {pmin:.3f}")
    check(l1 < 0.04 and abs(plateau - 0.2656) < 0.02 and pmin > 0, "Sod")

    states = []
    for where in (device, device, "cpu"):
        b = run_main(box_settings(core, n_check), device=where)
        states.append(b.state)
    rel = float(np.abs(states[0] - states[2]).max() / np.abs(states[2]).max())
    same = bool(np.array_equal(states[0], states[1]))
    print(f"[compressible] closed box {n_check} x {n_check}, {b.steps_taken} "
          f"steps: card against cpu max rel {rel:.2e} (tol 1e-12); two marches "
          f"on the card bit-equal {same}")
    check(rel <= 1e-12 and same, "closed box card vs CPU or repeat")


def phase_fsi(device=None, scale=8):
    """FSISolver through ``main(settings)`` on the default device: the
    pressure-loaded cantilever of tests/test_fsi.py on meshes ``scale``
    times as fine in each direction (8: fluid 80 x 32, P2/P1, 23,603 dofs,
    beyond the dense limit, so each Newton update takes ``fieldsplit``;
    solid 160 x 16, P2), the test's three steps, one line a step (the
    fluid's routes and outer iterations, the two mesh-motion PCG counts,
    the seconds of fluid, solid and mesh motion), the tip within 15% of
    Euler-Bernoulli; then at the test's size the card against the CPU
    after each step (1e-8): the fluid's ``up``, the solid's ``u`` and the
    moved fluid vertices."""
    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la import direct
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.solvers.fsi import FSISolver

    _reset_peak(device)
    t0 = time.perf_counter()
    fsi = run_main(fsi_cantilever(core, scale), device=device)
    wall = time.perf_counter() - t0
    fluid, solid = fsi.fluid_solver, fsi.solid_solver
    w_num, w_exact = cantilever_tip(fsi)
    rel = abs(w_num - w_exact) / abs(w_exact)
    print(f"[fsi] cantilever x{scale}: fluid {fluid.mesh.num_cells()} cells, "
          f"{fluid.function_space.ndof} dofs; solid {solid.mesh.num_cells()} "
          f"cells, {solid.function_space.ndof} dofs on {fsi.device}: main() "
          f"{wall:.2f} s, {fsi.steps_taken} steps; tip {w_num:.4e} against "
          f"Euler-Bernoulli {w_exact:.4e} ({100 * rel:.2f}%, tol 15%)"
          + _peak_text(device))
    for k, st in enumerate(fsi.last_steps, start=1):
        print(f"[fsi] step {k}: fluid {st['fluid_s']:.2f} s (routes "
              f"{st['fluid_routes']}, outer {st['fluid_outer']}), solid "
              f"{st['solid_s']:.2f} s, mesh motion {st['mesh_motion_s']:.3f} s "
              f"(PCG {st['mesh_motion_iterations'][0]} and "
              f"{st['mesh_motion_iterations'][1]})")
    if _on_card(device):
        check(fsi.device.type == "cuda", f"the FSI run was on {fsi.device}")
    check(fluid.function_space.ndof > direct.DENSE_LIMIT or scale != 8,
          "the fluid is below the dense limit")
    routes = {r for st in fsi.last_steps for r in st["fluid_routes"]}
    check(scale != 8 or routes == {"fieldsplit"},
          f"the fluid's Newton updates took {routes}")
    check(w_num < 0 and rel < 0.15, f"cantilever tip {w_num} against {w_exact}")
    del fsi

    runs = {where: fsi_snapshots(FSISolver(fsi_cantilever(core), device=where))
            for where in (device, "cpu")}
    worst = max(_rel_l2(a[key], b[key]) for a, b in zip(runs[device], runs["cpu"])
                for key in ("up", "u", "coords"))
    print(f"[fsi] the test's cantilever, {len(runs['cpu'])} steps: the card "
          f"against the cpu after each step, worst rel-L2 of up, u and the "
          f"fluid vertices {worst:.2e} (tol 1e-8)")
    check(len(runs[device]) == len(runs["cpu"]) == 3 and worst <= 1e-8,
          f"FSI card vs CPU {worst}")


# ---------------------------------------------------------------------------
# the distributed layer (parallel/halo.py, amg_halo.py, explicit.py): every
# sharded solve on SHARDS shards of one device (repeats of cuda:0)
# ---------------------------------------------------------------------------

#: shards of the distributed phases, all on the one card
SHARDS = 8
N_HALO, N_HALO_ELAS, N_ELEM = 64, 32, 48
N_AMG_HALO = 64  # the dry run's amg_unstructured_poisson, raised from 36
N_NS_FIELDSPLIT = 36  # the dry run's distributed_ns_fieldsplit_12k
N_EXPLICIT = 256  # the acoustic pulse: 66,049 nodes
N_ADVECTION = 48  # phase_advection's SUPG case: 117,649 dofs
#: the halo Krylov check's time step (CFL 0.29 at N_ADVECTION): the steady
#: system's BiCGStab takes ~150 iterations, and the sharded dot products'
#: rounding moves its path by a few of them (144 against 148 on the card)
DT_ADVECTION = 0.01


class _Shards:
    """``FST_SHARDS`` set for the block (the solver layer's shard count),
    and the warnings the solvers log in it."""

    def __init__(self, n):
        self.n = str(n)

    def __enter__(self):
        import logging

        self.saved = os.environ.get("FST_SHARDS")
        os.environ["FST_SHARDS"] = self.n
        self.records = []
        outer = self

        class Keep(logging.Handler):
            def emit(self, record):
                outer.records.append(record.getMessage())

        self.handler = Keep(logging.WARNING)
        logging.getLogger().addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger().removeHandler(self.handler)
        if self.saved is None:
            os.environ.pop("FST_SHARDS", None)
        else:
            os.environ["FST_SHARDS"] = self.saved

    def warned(self, text):
        return any(text in m for m in self.records)


def _shard_devices(device, n=SHARDS):
    return [device or "cuda:0"] * n


def _sync(device):
    import torch

    if _on_card(device):
        torch.cuda.synchronize()


def _loud(s):
    """Settings whose solver logs warnings (the F4 warning is checked)."""
    import logging

    s["report_settings"] = dict(s.get("report_settings") or {},
                                logging_level=logging.WARNING)
    return s


def _dist(s, value=True):
    s["solver_settings"].setdefault("solver_parameters", {})["distributed"] = value
    return s


def phase_distributed_one_shard(device=None, n=32, nx_ns=16):
    """F4 with one shard: a ``distributed: True`` heat case (the 2-D
    square, P1, two Dirichlet sides) and the NS channel each log the
    reference's warning, solve serially, and equal the same case without
    the flag bit for bit."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    def heat(distributed):
        V = core.FunctionSpace(core.UnitSquareMesh(n, n), "CG", 1)
        top = core.AutoSubDomain(lambda x: core.near(x[1], 1.0))
        bottom = core.AutoSubDomain(lambda x: core.near(x[1], 0.0))
        s = heat_settings(core, V)
        s["boundary_conditions"]["hot"]["boundary"] = top
        s["boundary_conditions"]["cold"]["boundary"] = bottom
        s["solver_settings"]["solver_parameters"].pop("preconditioner")
        return _dist(_loud(s), distributed) if distributed else _loud(s)

    cases = {"heat": heat,
             "ns": lambda d: (_dist(_loud(ns_channel(core, nx_ns)))
                              if d else _loud(ns_channel(core, nx_ns)))}
    for name, make in cases.items():
        with _Shards(1) as sh:
            plain = run_main(make(False), device=device)
            dist = run_main(make(True), device=device)
        same = np.array_equal(plain.result.values, dist.result.values)
        warned = sh.warned("only one device is visible; falling back to the "
                           "serial path")
        print(f"[distributed-one-shard] {name}: {dist.function_space.ndof} "
              f"dofs on {dist.device}, FST_SHARDS=1: warned {warned}, equal to "
              f"the run without the flag bit for bit {same}")
        check(warned and same, f"{name}: one-shard distributed run")


def _halo_against_serial(tag, A, b, dd, V, device, tol=1e-10):
    """HaloShardedSolver (Jacobi-PCG) on SHARDS shards against the port's
    serial Jacobi-CG on the same CSR system; two sharded solves bit-equal.
    Prints set-up and solve seconds and ms an iteration beside the serial."""
    import torch

    from fenicssolver_tpu_torch.la import krylov
    from fenicssolver_tpu_torch.ops import assembly
    from fenicssolver_tpu_torch.parallel.halo import HaloShardedSolver

    free, ubc = dd.free_mask, dd.u_bc
    _sync(device)
    t0 = time.perf_counter()
    op = assembly.constrained_operator(A.matvec, free)
    rhs = assembly.constrained_rhs(A.matvec, b, free, ubc)
    M = krylov.jacobi_preconditioner(free * A.diagonal() + (1 - free))
    x_ref, it_ref, _ = krylov.cg(op, rhs, M=M, tol=tol, maxiter=4000)
    _sync(device)
    t1 = time.perf_counter()
    hs = HaloShardedSolver(A, V.dof_coords, devices=_shard_devices(device))
    _sync(device)
    t2 = time.perf_counter()
    x, it = hs.solve(b, free, ubc, tol=tol, maxiter=4000)
    _sync(device)
    t3 = time.perf_counter()
    x2, it2 = hs.solve(b, free, ubc, tol=tol, maxiter=4000)
    rel = _rel_l2(x.cpu().numpy(), x_ref.cpu().numpy())
    same = bool(torch.equal(x, x2)) and it == it2
    print(f"[halo] {tag}: {V.ndof} dofs, {hs.n_dev} shards of {x.device}, "
          f"local length {hs.Lp}, {len(hs.perms)} exchange rounds: set-up "
          f"{t2 - t1:.3f} s, Jacobi-PCG {it} iterations {t3 - t2:.3f} s "
          f"({(t3 - t2) / max(it, 1) * 1e3:.3f} ms an iteration); serial CSR "
          f"Jacobi-CG {it_ref} iterations {(t1 - t0) / max(it_ref, 1) * 1e3:.3f} "
          f"ms an iteration; rel-L2 {rel:.2e} (tol 1e-10); two solves "
          f"bit-equal {same}")
    check(rel <= 1e-10 and abs(it - it_ref) <= 2,
          f"{tag}: rel-L2 {rel}, iterations {it} vs {it_ref}")
    check(same, f"{tag}: two sharded solves differ")
    return hs


def _htc_facet_term(core, V, mesh, fids, device, dtype, htc=5.0, Ta=300.0):
    """An HTC (Robin) term h (T - Ta) on the facets ``fids``."""
    import torch

    from fenicssolver_tpu_torch.ops import assembly, geometry

    fphi_tab, _, fw, _ = geometry.facet_basis_tables(mesh.tdim, 1, 2)
    fphi = torch.as_tensor(fphi_tab, dtype=dtype, device=device)
    fwj = torch.as_tensor(fw, dtype=dtype, device=device)

    def kernel(ue, geom, aux):
        phif = torch.index_select(fphi, 0, geom.local_id.reshape(1))[0]
        val = htc * (Ta - phif @ ue)
        return -torch.einsum("q,q,qi->i", fwj * geom.detF, val, phif)

    ctx = geometry.build_facet_context(V, fids, 2, device=device, dtype=dtype)
    return assembly.FacetTerm(kernel=kernel, ctx=ctx)


def phase_halo(device=None, n=N_HALO, n_elas=N_HALO_ELAS, n_elem=N_ELEM,
               n_adv=N_ADVECTION):
    """``parallel/halo.py`` on SHARDS shards of the card, f64, each against
    the port's serial solve of the same system: (a) Jacobi-PCG of the P1
    Poisson problem on ``UnitCubeMesh(n)`` (rel-L2 1e-10, iterations within
    2); (b) the same for P1 elasticity at ``n_elas``; (c)
    ``HaloElementSolver`` (the element-sharded assembly) of Poisson at
    ``n_elem`` with an HTC facet term on x = 1, against the serial assembly
    and CG; (d) the non-SPD route that users get (``distributed: True`` on
    one implicit step of ``phase_advection``'s SUPG case at ``n_adv``
    through ``main()``:
    ``SolverBase._halo_krylov``, BiCGStab and GMRES(80) after a stall)
    against the serial run: the same method, iterations within 2, rel-L2
    1e-8 (BiCGStab's iterates carry its rounding further than CG's); (e)
    two solves of (a) bit-equal."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la import krylov
    from fenicssolver_tpu_torch.ops import assembly
    from fenicssolver_tpu_torch.parallel.halo import (
        HaloElementSolver,
        HaloShardedSolver,
        batches_from_form,
    )

    dev = device or "cuda:0"
    f64 = torch.float64
    t_phase = time.perf_counter()
    for tag, kern, nn, vec in (("Poisson", poisson_kernel, n, False),
                               ("elasticity", elasticity_kernel, n_elas, True)):
        V, _, form, _, dd = sharded_problem(core, kern, nn, vec, dev, f64)
        form.finalize()
        A, b = assembly.assemble_linear_system(form, dtype=f64)
        _halo_against_serial(f"{tag} UnitCubeMesh({nn})", A, b, dd, V, device)
        del V, form, A, b, dd

    # (c) the element-sharded assembly with a facet term
    V, kernel, form, _, _ = sharded_problem(core, poisson_kernel, n_elem, False,
                                            dev, f64)
    mesh = V.mesh
    ext = mesh.exterior_facets()
    xm = mesh.coords[mesh.facets()[ext]].mean(axis=1)
    robin = ext[np.isclose(xm[:, 0], 1.0)]
    form.facet_terms.append(_htc_facet_term(core, V, mesh, robin, dev, f64))
    form.finalize()
    X = V.dof_coords
    fixed = np.nonzero((X[:, 0] == 0.0) | np.any(
        (X[:, 1:] == 0.0) | (X[:, 1:] == 1.0), axis=1))[0]
    dd = assembly.DirichletData(V.ndof)
    dd.add(fixed, 0.0)
    dd.finalize(device=dev, dtype=f64)
    _sync(device)
    t0 = time.perf_counter()
    hs = HaloElementSolver(batches_from_form(form, f64), V.dof_coords, V.ndof,
                           devices=_shard_devices(device), dtype=f64)
    _sync(device)
    t1 = time.perf_counter()
    x, it = hs.solve(dd.free_mask, dd.u_bc, tol=1e-10, maxiter=4000)
    _sync(device)
    t2 = time.perf_counter()
    A, b = assembly.assemble_linear_system(form, dtype=f64)
    op = assembly.constrained_operator(A.matvec, dd.free_mask)
    rhs = assembly.constrained_rhs(A.matvec, b, dd.free_mask, dd.u_bc)
    M = krylov.jacobi_preconditioner(dd.free_mask * A.diagonal()
                                     + (1 - dd.free_mask))
    x_ref, it_ref, _ = krylov.cg(op, rhs, M=M, tol=1e-10, maxiter=4000)
    rel = _rel_l2(x.cpu().numpy(), x_ref.cpu().numpy())
    print(f"[halo] element-sharded Poisson UnitCubeMesh({n_elem}) with an HTC "
          f"term on {len(robin)} facets: {V.ndof} dofs, {hs.n_dev} shards, "
          f"local length {hs.Lp}: set-up {t1 - t0:.3f} s, assembly and "
          f"Jacobi-PCG {t2 - t1:.3f} s, {it} iterations (serial {it_ref}); "
          f"rel-L2 against the serial assembly and CG {rel:.2e} (tol 1e-10)")
    check(rel <= 1e-10 and abs(it - it_ref) <= 2,
          f"element-sharded: rel-L2 {rel}, iterations {it} vs {it_ref}")
    del V, form, hs, A, b, dd

    # (d) the non-SPD distributed route, SolverBase._halo_krylov
    from fenicssolver_tpu_torch.main import main as run_main

    V = core.FunctionSpace(core.UnitCubeMesh(n_adv, n_adv, n_adv), "CG", 1)

    def step():
        s = advection_case(core, V)
        s["solver_settings"]["transient_settings"] = {
            "transient": True, "starting_time": 0.0, "time_step": DT_ADVECTION,
            "ending_time": DT_ADVECTION}
        return s

    t0 = time.perf_counter()
    ref = run_main(step(), device=device)
    t1 = time.perf_counter()
    with _Shards(SHARDS):
        dist = run_main(_dist(step()), device=device)
    t2 = time.perf_counter()
    rel = _rel_l2(dist.result.values, ref.result.values)
    halo = dist.timers.totals.get("halo_krylov", 0.0)
    print(f"[halo] SUPG advection UnitCubeMesh({n_adv}), one step of "
          f"{DT_ADVECTION} through main(), {V.ndof} dofs, {SHARDS} shards: "
          f"{dist.last_krylov} (halo Krylov "
          f"{halo:.3f} s) in {dist.last_iterations} iterations, rel res "
          f"{dist.last_relres:.2e}, main() {t2 - t1:.2f} s; serial "
          f"{ref.last_krylov} in {ref.last_iterations} iterations, rel res "
          f"{ref.last_relres:.2e}, main() {t1 - t0:.2f} s; rel-L2 {rel:.2e} "
          "(tol 1e-8)")
    check(halo > 0 and dist.last_krylov == ref.last_krylov
          and abs(dist.last_iterations - ref.last_iterations) <= 2
          and rel <= 1e-8,
          f"halo Krylov: route {dist.last_krylov} vs {ref.last_krylov}, "
          f"iterations {dist.last_iterations} vs {ref.last_iterations}, "
          f"rel-L2 {rel}")
    print(f"[halo] phase {time.perf_counter() - t_phase:.2f} s")


def halo_hierarchy_digests(hs):
    """The ``digest`` of every host array of a ``HaloAMGSolver``'s
    hierarchy, by level: [(level, name, digest)], the coarse level last."""
    import numpy as np

    out = []
    for li, lv in enumerate(hs._levels_host):
        for name in ("A", "P", "R"):
            M = lv[name]
            out.append((li, name, (M.indptr, M.indices, M.data)))
        out += [(li, "agg", (lv["agg"],)), (li, "l1", (lv["l1"],)),
                (li, "lam1", (np.float64(lv["lam1"]),))]
    c = hs._coarse_host
    L = len(hs._levels_host)
    out += [(L, "coarse A", (c["A"].indptr, c["A"].indices, c["A"].data)),
            (L, "coarse l1", (c["l1"],)),
            (L, "coarse lam1", (np.float64(c["lam1"]),))]
    return [(li, name, digest(a)) for li, name, a in out]


def phase_amg_halo(device=None, n=N_AMG_HALO, nx_ns=N_NS_FIELDSPLIT,
                   n_twist=5):
    """``parallel/amg_halo.py`` and the routes through it, on SHARDS
    shards: (a) the dry run's ``amg_unstructured_poisson`` (perturbed tets,
    scrambled numbering) at ``n``: the sharded AMG-CG within 2 iterations
    above the port's serial AMG-CG and rel-L2 1e-10 against it, set-up and
    solve seconds apart; (b) ``distributed_ns_fieldsplit_12k`` (the mild
    channel at ``nx_ns``): every Newton update on the sharded fieldsplit
    route, the final outer count within 15% of the serial fieldsplit's,
    rel-L2 1e-8 against the serial run; (c)
    ``distributed_newton_hyperelastic`` (the twist at ``n_twist``^3): every
    update on the sharded AMG route, against the serial Newton to 1e-10.
    F5: each hierarchy applied twice and a second solve repeat bit for bit,
    and a second sharded set-up gives the same bits on every level and the
    same count."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.core.meshgen import perturbed_tet_box
    from fenicssolver_tpu_torch.la import direct, krylov
    from fenicssolver_tpu_torch.la.amg import AMGPreconditioner
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.ops import assembly, geometry
    from fenicssolver_tpu_torch.parallel.amg_halo import HaloAMGSolver
    from fenicssolver_tpu_torch.solvers.navier_stokes import (
        CoupledNavierStokesSolver,
    )

    dev = device or "cuda:0"
    f64 = torch.float64
    t_phase = time.perf_counter()
    mesh = perturbed_tet_box(n)
    V = core.FunctionSpace(mesh, "CG", 1)
    ctx = geometry.build_cell_context(V, 2, device=dev, dtype=f64)
    form = assembly.Form(space=V, cell_terms=[assembly.CellTerm(
        kernel=poisson_kernel(dev, f64), ctx=ctx)])
    form.finalize()
    A, b = assembly.assemble_linear_system(form, dtype=f64)
    dd = assembly.DirichletData(V.ndof)
    dd.add(V.facet_dofs(mesh.exterior_facets()), 0.0)
    dd.finalize(device=dev, dtype=f64)
    free = dd.free_mask
    _sync(device)
    t0 = time.perf_counter()
    M = AMGPreconditioner(assembly.constrain_csr(A, free).to_host(),
                          free_mask=free.cpu().numpy() > 0.5, dtype=f64,
                          device=dev)
    _sync(device)
    t1 = time.perf_counter()
    op = assembly.constrained_operator(A.matvec, free)
    rhs = assembly.constrained_rhs(A.matvec, b, free, dd.u_bc)
    x_ref, it_ref, _ = krylov.cg(op, rhs, M=M, tol=1e-10, maxiter=300)
    _sync(device)
    t2 = time.perf_counter()
    hs = HaloAMGSolver(A, V.dof_coords, free.cpu().numpy(),
                       devices=_shard_devices(device))
    _sync(device)
    t3 = time.perf_counter()
    x, it, res = hs.solve(b, dd.u_bc, tol=1e-10, maxiter=300)
    _sync(device)
    t4 = time.perf_counter()
    rel = _rel_l2(x.cpu().numpy(), x_ref.cpu().numpy())
    steps = {}
    for lv in hs.levels:
        for k, v in lv["steps"].items():
            steps[k] = steps.get(k, 0.0) + v
    print(f"[amg-halo] unstructured Poisson (perturbed tets) n = {n}: "
          f"{V.ndof} dofs, {hs.n_dev} shards, levels "
          f"{[lv['rows'] for lv in hs.levels]} + coarse {hs.n_coarse}, "
          f"operator complexity {hs.operator_complexity:.3f}: set-up "
          f"{t3 - t2:.2f} s (hierarchy steps "
          + ", ".join(f"{k} {v:.2f}" for k, v in steps.items())
          + f"), AMG-CG {it} iterations {t4 - t3:.3f} s, rel res {res:.2e}; "
          f"serial AMG set-up {t1 - t0:.2f} s, CG {it_ref} iterations "
          f"{t2 - t1:.3f} s; rel-L2 {rel:.2e} (tol 1e-10)")
    check(it <= it_ref + 2 and rel <= 1e-10,
          f"sharded AMG: {it} iterations vs serial {it_ref}, rel-L2 {rel}")
    # F5: each hierarchy (serial, sharded) applied twice to one vector gives
    # the same bits, a second CG solve with it the same count and bits
    lay0 = hs._lay[0]
    gen = torch.Generator(device=lay0.own.device).manual_seed(5)
    v = lay0.own * torch.randn(lay0.own.shape, generator=gen, dtype=f64,
                               device=lay0.own.device)
    same_v = (torch.equal(hs.vcycle(v), hs.vcycle(v)),
              torch.equal(M(rhs), M(rhs)))
    t5 = time.perf_counter()
    x2, it2, _ = hs.solve(b, dd.u_bc, tol=1e-10, maxiter=300)
    x_ref2, it_ref2, _ = krylov.cg(op, rhs, M=M, tol=1e-10, maxiter=300)
    _sync(device)
    same_x = (torch.equal(x2, x), torch.equal(x_ref2, x_ref))
    print(f"[amg-halo] F5: V-cycle twice bit-equal (sharded, serial) {same_v}; "
          f"second solves {it2} and {it_ref2} iterations (first {it} and "
          f"{it_ref}), bit-equal {same_x}, {time.perf_counter() - t5:.2f} s")
    check(all(same_v), f"an AMG V-cycle applied twice differs: {same_v}")
    check(it2 == it and it_ref2 == it_ref and all(same_x),
          f"second AMG-CG solves: {it2}, {it_ref2} against {it}, {it_ref}; "
          f"bit-equal {same_x}")
    # F5's set-up part: a second sharded set-up gives the same bits on every
    # level and its solve the same count and bits
    t5 = time.perf_counter()
    hs2 = HaloAMGSolver(A, V.dof_coords, free.cpu().numpy(),
                        devices=_shard_devices(device))
    x3, it3, _ = hs2.solve(b, dd.u_bc, tol=1e-10, maxiter=300)
    _sync(device)
    diff = first_difference(halo_hierarchy_digests(hs),
                            halo_hierarchy_digests(hs2))
    print(f"[amg-halo] [amg-setup-repeat] a second sharded set-up: first "
          f"level and array that differ {diff or 'none'}; its AMG-CG {it3} "
          f"iterations (first {it}), bit-equal {torch.equal(x3, x)}, "
          f"{time.perf_counter() - t5:.2f} s")
    check(diff is None, f"two sharded AMG set-ups differ at {diff} (level, "
          "array)")
    check(it3 == it and torch.equal(x3, x),
          f"the second sharded set-up's solve: {it3} iterations against {it}")
    del V, form, A, b, dd, hs, hs2, M, ctx, x2, x_ref2, x3, v

    # (b) the distributed NS fieldsplit at 12k mixed dofs
    def mild(**params):
        s = ns_channel(core, nx_ns)
        s["boundary_conditions"]["inlet"]["values"][0]["value"] = core.Expression(
            ("umax*4.0*x[1]*(1.0-x[1])", "0"), umax=0.15, degree=2)
        s["solver_settings"]["solver_parameters"].update(
            relative_tolerance=1e-10, **params)
        return s

    saved = direct.DENSE_LIMIT
    try:
        direct.DENSE_LIMIT = 100  # the serial run takes the iterative fieldsplit
        t0 = time.perf_counter()
        ref = CoupledNavierStokesSolver(mild(preconditioner="fieldsplit"),
                                        device=device)
        up_ref = ref.solve().values.copy()
        t1 = time.perf_counter()
    finally:
        direct.DENSE_LIMIT = saved
    with _Shards(SHARDS):
        dist = CoupledNavierStokesSolver(mild(distributed=True,
                                              gmres_restart=100), device=device)
        up = dist.solve().values
    t2 = time.perf_counter()
    routes = [st["route"] for st in dist.last_newton]
    outer = [st["iterations"] for st in dist.last_newton]
    it_s, it_d = int(ref._last_outer_iters), int(dist._last_outer_iters)
    rel = _rel_l2(up, up_ref)
    print(f"[amg-halo] distributed NS channel {nx_ns} x {nx_ns}: "
          f"{dist.function_space.ndof} mixed dofs, {SHARDS} shards: Newton "
          f"routes {routes}, outer {outer}, final {it_d} against the serial "
          f"fieldsplit's {it_s} (tol +15%); {t2 - t1:.2f} s (serial "
          f"{t1 - t0:.2f} s); rel-L2 {rel:.2e} (tol 1e-8)")
    check(set(routes) == {"halo_fieldsplit"}, f"NS routes {routes}")
    check(it_d <= 1.15 * it_s and rel <= 1e-8,
          f"distributed NS: outer {it_d} vs {it_s}, rel-L2 {rel}")
    del ref, dist

    # (c) the distributed Newton of the hyperelastic twist
    def twist(**params):
        s = twist_settings(core, (n_twist,) * 3)
        s["solver_settings"]["solver_parameters"].update(params)
        return s

    serial = run_main(twist(), device=device)
    with _Shards(SHARDS):
        t0 = time.perf_counter()
        dist = run_main(twist(distributed=True), device=device)
        t1 = time.perf_counter()
    rel = _rel_l2(dist.result.values, serial.result.values)
    routes = [st["route"] for st in dist.last_newton]
    print(f"[amg-halo] distributed Newton, the twist at {n_twist}^3: "
          f"{dist.function_space.ndof} dofs, Newton {dist.last_iterations} "
          f"steps (serial {serial.last_iterations}), routes {routes}, updates' "
          f"AMG-CG iterations {[st['iterations'] for st in dist.last_newton]}, "
          f"{t1 - t0:.2f} s; rel-L2 against the serial Newton {rel:.2e} (tol "
          f"1e-10)")
    check(set(routes) == {"halo_amg"} and rel <= 1e-10,
          f"distributed Newton: routes {routes}, rel-L2 {rel}")
    print(f"[amg-halo] phase {time.perf_counter() - t_phase:.2f} s")


def phase_explicit(device=None, n=N_EXPLICIT):
    """``parallel/explicit.py``: the acoustic pulse at ``n`` x ``n`` marched
    on SHARDS shards against the serial march: max relative difference
    1e-12, mass and energy conserved to 1e-12 as in the compressible phase,
    ms a step beside the serial."""
    import numpy as np

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    serial = run_main(_pulse_vectorised(pulse_settings(core, n)), device=device)
    with _Shards(SHARDS):
        dist = run_main(_dist(_pulse_vectorised(pulse_settings(core, n))),
                        device=device)
    st = dist.last_stepper
    ml = serial._tables["mlump"].cpu().numpy()
    tot0 = (serial._initial_state() * ml[None, :]).sum(axis=1)
    tot1 = (dist.state * ml[None, :]).sum(axis=1)
    dm = abs(tot1[0] - tot0[0]) / tot0[0]
    dE = abs(tot1[-1] - tot0[-1]) / abs(tot0[-1])
    rel = float(np.abs(dist.state - serial.state).max()
                / np.abs(serial.state).max())
    ms = dist.timers.totals["march"] / dist.steps_taken * 1e3
    ms_s = serial.timers.totals["march"] / serial.steps_taken * 1e3
    print(f"[explicit] acoustic pulse {n} x {n}: {dist.function_space.ndof} "
          f"nodes, {st.n_dev} shards (local length {st.Lp}, "
          f"{len(st.perms)} exchange rounds), {dist.steps_taken} SSP-RK2 "
          f"steps: {ms:.3f} ms a step sharded, {ms_s:.3f} ms serial; max rel "
          f"difference {rel:.2e} (tol 1e-12); d(mass)/mass {dm:.2e}, d(E)/E "
          f"{dE:.2e} (tol 1e-12)")
    check(rel <= 1e-12 and dm < 1e-12 and dE < 1e-12,
          f"sharded march: {rel}, {dm}, {dE}")


def phase_distributed_fsi(device=None, scale=4):
    """The FSI cantilever of tests/test_fsi.py ``scale`` times as fine with
    ``distributed: True`` on SHARDS shards (the fluid's halo fieldsplit
    FGMRES, the solid's sharded AMG-CG, the mesh motion's halo CG) against
    the serial run: the tip within 1e-8 relative; the mesh-motion PCG
    counts."""
    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.main import main as run_main

    t0 = time.perf_counter()
    serial = run_main(fsi_cantilever(core, scale), device=device)
    t1 = time.perf_counter()
    s = fsi_cantilever(core, scale)
    s["solver_settings"] = {"solver_parameters": {"distributed": True}}
    with _Shards(SHARDS):
        dist = run_main(s, device=device)
    t2 = time.perf_counter()
    w_s, _ = cantilever_tip(serial)
    w_d, w_exact = cantilever_tip(dist)
    rel = abs(w_d - w_s) / abs(w_s)
    routes = {r for st in dist.last_steps for r in st["fluid_routes"]}
    print(f"[distributed-fsi] cantilever x{scale}: fluid "
          f"{dist.fluid_solver.function_space.ndof} dofs, solid "
          f"{dist.solid_solver.function_space.ndof} dofs, {SHARDS} shards: "
          f"{t2 - t1:.2f} s (serial {t1 - t0:.2f} s); fluid routes {routes}, "
          f"solid {dist.solid_solver.last_preconditioner}-"
          f"{dist.solid_solver.last_krylov}; mesh-motion PCG "
          f"{dist._mm_iterations} (serial {serial._mm_iterations}); tip "
          f"{w_d:.6e} against the serial {w_s:.6e} (rel {rel:.2e}, tol 1e-8)")
    check(routes == {"halo_fieldsplit"} and dist._mm_halo.n_dev == SHARDS,
          f"distributed FSI routes {routes}")
    check(rel <= 1e-8, f"distributed FSI tip {w_d} vs {w_s}")


#: the dry run's lattice cases (``__graft_entry__.py:762-788``), raised:
#: lattice_gmg_poisson3d_64 to the heat path's lattice, 2,146,689 dofs;
#: lattice_gmg_2axis from 32 to 64; lattice_gmg_pencil_48 to 96
N_LATTICE_HALO, N_LATTICE_AXES, N_LATTICE_PENCIL = 128, 64, 96
#: bench.py's BENCH_N_ELAS (``bench.py:2191``): 3 * 81^3 = 1,594,323 dofs
N_ELAS_BENCH = 80


def _lattice_system(n, device):
    """The dry run's lattice Poisson system (f = 1, Dirichlet shell) at n on
    the card in f64: the stencil fields and load of ``assemble_stencil``
    (K3) and the free mask."""
    import torch

    from fenicssolver_tpu_torch.ops.stencil_assembly import (
        assemble_stencil,
        box_geometry,
    )

    JinvT, detJ = box_geometry((n, n, n), dtype=torch.float64, device=device)
    coef, b3 = assemble_stencil(JinvT, detJ, (n, n, n), mode="sym")
    free = torch.zeros_like(b3)
    free[1:-1, 1:-1, 1:-1] = 1.0
    return coef, b3.reshape(-1), free.reshape(-1)


def _lattice_kernels_agree(what, ls, free):
    """K1 and K2 against their plain versions on a lattice solver's own
    inputs (one card: one device group), f64 at ``TOL``: its stacked haloed
    fields ``_coef_e`` and each sharded level's haloed mask, on a seeded
    vector split and haloed at that level's shape (K1 masked and unmasked at level 0, as the CG operator and
    the Dirichlet lift call it; K2 at every sharded level with that level's
    taps).  Returns each kernel's max abs error."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels

    dtype = torch.float64
    _, free_e, _, _ = ls._level_data(free, dtype)
    free_e = [f.parts[0] for f in free_e]
    coef_e = ls._coef_e[0].to(dtype)
    errs = {"stencil_apply_var": 0.0, "stencil_apply_const": 0.0}
    shapes = []
    for l in range(ls.Ls):
        nl = tuple(((v - 1) >> l) + 1 for v in ls.shape3)
        x = torch.as_tensor(np.random.default_rng(l).standard_normal(nl),
                            dtype=dtype, device=ls.device)
        xe = ls._halo(ls._split(x, l), l).parts[0]
        flat = xe.reshape((-1,) + tuple(xe.shape[-2:]))
        shapes.append(tuple(flat.shape))
        cases = [("stencil_apply_const", f"K2 level {l}",
                  lambda f=free_e[l], t=ls.taps[l]:
                      cuda_kernels.stencil_apply_const(flat, t, f),
                  lambda f=free_e[l], t=ls.taps[l]:
                      cuda_kernels.stencil_apply_const_reference(flat, t, f))]
        if l == 0:
            cases += [("stencil_apply_var", f"K1 {mname}",
                       lambda f=f: cuda_kernels.stencil_apply_var(
                           flat, coef_e, f),
                       lambda f=f: cuda_kernels.stencil_apply_var_reference(
                           flat, coef_e, f))
                      for mname, f in (("masked", free_e[0]),
                                       ("unmasked", None))]
        for name, k, kernel, plain in cases:
            err, _ = _agree("lattice-halo", f"{what} {k} {tuple(flat.shape)}",
                            kernel, plain, TOL["float64"])
            errs[name] = max(errs[name], err)
        del x, xe, flat
    print(f"[lattice-halo] {what}: K1 and K2 against their plain versions on "
          f"the solver's stacked haloed inputs {shapes} (f64, tol "
          f"{TOL['float64']:g}): max abs err K1 "
          f"{errs['stencil_apply_var']:.2e}, K2 "
          f"{errs['stencil_apply_const']:.2e}")
    return errs


def phase_lattice_halo(device=None, V=None, T_serial=None, n=N_LATTICE_HALO,
                       n_axes=N_LATTICE_AXES, n_pencil=N_LATTICE_PENCIL):
    """``parallel/lattice.py`` on SHARDS shards of the card, f64, each held
    to the port's serial GMG-CG (``run_stencil(n, tol=1e-10)``) on the same
    system at rtol 1e-10: the slab solver at ``n``, the two-axis slab solver
    (("dcn", 2), ("ici", 4)) at ``n_axes``, the 2 x 4 pencil solver at
    ``n_pencil`` (iterations, ms an iteration sharded and serial, K1 and K2
    launches, two solves bit-equal), and K1 and K2 against their plain
    versions on each solver's own inputs (``_lattice_kernels_agree``); then
    the solver route: the heat case of ``phase_main_path`` through
    ``main()`` with ``distributed: true`` on its space ``V`` against its
    serial solution ``T_serial``.  Returns the K1 and K2 launches of the
    lattice runs (each reset just before the run and read just after) and
    the kernels' max abs errors on the lattice inputs."""
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.lattice_poisson import run_stencil
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.ops import cuda_kernels
    from fenicssolver_tpu_torch.parallel.lattice import (
        LatticeHaloSolver,
        LatticePencilSolver,
    )

    dev = device or "cuda:0"
    kernels = ("stencil_apply_var", "stencil_apply_const")
    launches = dict.fromkeys(kernels, 0)
    errs = dict.fromkeys(kernels, 0.0)
    shards = _shard_devices(device)
    cases = (
        ("slabs", n, lambda c, info: LatticeHaloSolver(c, info, devices=shards)),
        ("two axes (dcn 2) x (ici 4)", n_axes,
         lambda c, info: LatticeHaloSolver(
             c, info, devices=shards, mesh_axes=(("dcn", 2), ("ici", 4)))),
        ("pencils 2 x 4", n_pencil,
         lambda c, info: LatticePencilSolver(c, info, devices=shards,
                                             mesh_shape=(2, 4))),
    )
    for what, nn, make in cases:
        ser = run_stencil(nn, tol=1e-10, dtype=torch.float64, device=dev)
        coef, b, free = _lattice_system(nn, dev)
        _sync(device)
        t0 = time.perf_counter()
        ls = make(coef, {"n": (nn, nn, nn)})
        del coef
        _sync(device)
        t1 = time.perf_counter()
        cuda_kernels.reset_launch_counts()
        x, it = ls.solve(b, free, torch.zeros_like(b), tol=1e-10, maxiter=200)
        _sync(device)
        t2 = time.perf_counter()
        counts = {k: cuda_kernels.LAUNCHES[k] for k in kernels}
        for k in kernels:
            launches[k] += counts[k]
        x2, it2 = ls.solve(b, free, torch.zeros_like(b), tol=1e-10, maxiter=200)
        _sync(device)
        t3 = time.perf_counter()
        rel = _rel_l2(x.cpu().numpy(), ser["u"].cpu().numpy())
        print(f"[lattice-halo] {what} at n = {nn}: {x.numel()} dofs, "
              f"{ls.n_dev} shards, {ls.Ls} sharded levels: set-up "
              f"{t1 - t0:.2f} s, first solve {t2 - t1:.3f} s, {it} iterations "
              f"(serial GMG-CG {ser['iterations']}); "
              f"{1e3 * (t3 - t2) / max(it2, 1):.3f} ms an iteration sharded "
              f"against {1e3 * ser['solve_s'] / max(ser['iterations'], 1):.3f} "
              f"serial; launches K1 {counts['stencil_apply_var']}, K2 "
              f"{counts['stencil_apply_const']}; rel-L2 against the serial "
              f"{rel:.2e} (tol 1e-8); a second solve bit-equal "
              f"{torch.equal(x, x2)}")
        check(rel <= 1e-8, f"lattice {what}: rel-L2 {rel} against the serial")
        check(it <= ser["iterations"] + 2, f"lattice {what}: {it} iterations "
              f"against the serial {ser['iterations']}")
        check(all(counts[k] > 0 for k in kernels),
              f"lattice {what} did not launch K1 and K2: {counts}")
        check(it2 == it and torch.equal(x, x2),
              f"lattice {what}: a second solve differs")
        for k, e in _lattice_kernels_agree(what, ls, free).items():
            errs[k] = max(errs[k], e)
        del ls, x, x2, ser, b, free

    # the solver route: the steady heat case with distributed: true
    s = _dist(heat_settings(core, V))
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _Shards(SHARDS):
        solver = run_main(s, device=device)
    wall = time.perf_counter() - t0
    counts = {k: cuda_kernels.LAUNCHES[k] for k in kernels}
    for k in kernels:
        launches[k] += counts[k]
    tt = solver.timers.totals
    rel = _rel_l2(solver.result.values, T_serial)
    print(f"[lattice-halo] heat case through main(), distributed: true, "
          f"{V.ndof} dofs: {solver.last_preconditioner}-{solver.last_krylov} "
          f"{solver.last_iterations} iterations, main() {wall:.2f} s (lattice "
          f"set-up {tt.get('lattice_setup', 0):.2f} s, solve "
          f"{tt.get('lattice_krylov', 0):.2f} s); launches K1 "
          f"{counts['stencil_apply_var']}, K2 {counts['stencil_apply_const']}; "
          f"rel-L2 against the serial GMG-CG {rel:.2e} (tol 1e-8)")
    check(solver.last_preconditioner == "lattice_gmg",
          f"the distributed heat case ran {solver.last_preconditioner}, not "
          "the lattice GMG")
    check(rel <= 1e-8, f"distributed heat rel-L2 {rel}")
    check(all(counts[k] > 0 for k in kernels),
          f"the heat route did not launch K1 and K2: {counts}")
    return {"launches": launches, "max_abs_err": errs}


def phase_lattice_elasticity(device=None, serial=None, n_bench=N_ELAS_BENCH,
                             n_check=16):
    """The vector lattice route: ``LinearElasticitySolver`` with
    ``distributed: true`` on ``phase_elasticity``'s cantilever (``serial``:
    its V, bcs and AMG-CG solution to 1e-10) on SHARDS shards, by the
    sharded vector GMG with the truncated-tap hierarchy, to 1e-10: the tip
    and the rel-L2 against the serial AMG-CG within 1e-6, the iterations,
    the block operator's ms; then ``lattice_poisson.run_elasticity`` at
    ``n_bench`` in f32 (``bench.py``'s elasticity path) and at ``n_check``
    in f64 on the card against the CPU (1e-10, equal iterations)."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch.lattice_poisson import run_elasticity
    from fenicssolver_tpu_torch.main import main as run_main

    V, bcs = serial["V"], serial["bcs"]
    t0 = time.perf_counter()
    with _Shards(SHARDS):
        solver = run_main(_dist(elasticity_settings(V, bcs, rtol=1e-10)),
                          device=device)
    wall = time.perf_counter() - t0
    ls = solver._lattice_halo_solver
    tt = solver.timers.totals
    x = solver.result.values.ravel()
    rel = _rel_l2(x, serial["x"])
    X = V.scalar_space.dof_coords
    tip_of = (lambda u: float(u.reshape(-1, 3)[abs(X[:, 0] - X[:, 0].max())
                                               < 1e-9, 1].mean()))
    tip, tip_s = tip_of(x), tip_of(serial["x"])
    it = solver.last_iterations
    xt = ls.groups.sharded([torch.randn(
        (ls.n_dev, 3, ls.mp[0]) + ls.shape3[1:], dtype=torch.float64,
        device=ls.device)], 0)
    block_ms = time_ms(lambda: ls._apply(xt, 0, ls._coef), reps=5, warmup=1)
    print(f"[lattice-elasticity] cantilever {ls.shape3}, {V.ndof} dofs, "
          f"{ls.n_dev} shards, {ls.Ls} sharded levels + tail {ls._tail_n}, "
          f"truncated taps {ls.truncated}: {solver.last_preconditioner}-"
          f"{solver.last_krylov} {it} iterations to 1e-10 (serial AMG-CG "
          f"{serial['iterations']}, {serial['seconds']:.2f} s); main() "
          f"{wall:.2f} s (lattice set-up {tt.get('lattice_setup', 0):.2f} s, "
          f"solve {tt.get('lattice_krylov', 0):.2f} s, "
          f"{1e3 * tt.get('lattice_krylov', 0) / max(it, 1):.1f} ms an "
          f"iteration); the block operator at level 0 {block_ms:.3f} ms (4 a "
          f"V-cycle at each sharded level, 1 an iteration); tip {tip:.6e} "
          f"against {tip_s:.6e} (rel {abs(tip - tip_s) / abs(tip_s):.2e}), "
          f"rel-L2 {rel:.2e} (tol 1e-6)")
    check(solver.last_preconditioner == "lattice_gmg_vector" and ls.truncated,
          f"the distributed cantilever ran {solver.last_preconditioner}")
    check(rel <= 1e-6 and abs(tip - tip_s) <= 1e-6 * abs(tip_s),
          f"vector lattice against the serial AMG-CG: rel-L2 {rel}, tip "
          f"{tip} vs {tip_s}")
    del solver, ls, xt, x

    r = run_elasticity(n_bench, dtype=torch.float32, device=device)
    check_r = {}
    for where in (device, "cpu"):
        c = run_elasticity(n_check, tol=1e-10, dtype=torch.float64,
                           device=where)
        check_r[where] = (c["u"].cpu().numpy(), c["iterations"], c["u_max"])
    (ug, ig, mg), (uc, ic, _) = check_r[device], check_r["cpu"]
    rel = _rel_l2(ug, uc)
    print(f"[lattice-elasticity] run_elasticity({n_bench}) f32: {r['ndof']} "
          f"dofs, {r['iterations']} iterations, rel res {r['relres']:.3e}, "
          f"umax {r['u_max']:.6e}; set-up {r['setup_s']:.2f} s, assembly "
          f"{r['assembly_s']:.3f} s, solve {r['solve_s']:.3f} s "
          f"({1e3 * r['solve_s'] / max(r['iterations'], 1):.2f} ms an "
          f"iteration); n = {n_check} f64: {ig} iterations on the card, {ic} "
          f"on the CPU, rel-L2 {rel:.2e} (tol 1e-10)")
    check(r["ndof"] == 3 * (n_bench + 1) ** 3 and r["relres"] <= 1e-6
          and np.isfinite(r["u_max"]), f"run_elasticity({n_bench}): {r}")
    check(abs(r["u_max"] - mg) <= 0.05 * mg,
          f"umax {r['u_max']} at n = {n_bench} against {mg} at n = {n_check}")
    check(rel <= 1e-10 and ig == ic, f"run_elasticity({n_check}) card vs CPU: "
          f"rel-L2 {rel}, iterations {ig} vs {ic}")


#: the multi-device phase's sizes: the slab lattice at 129^3 (2,146,689
#: dofs), the unstructured AMG at 65^3 (274,625 dofs), the element-sharded
#: Poisson at 48^3, the acoustic pulse at 1025^2 (1,050,625 nodes, a few
#: steps), K5's Poisson at 64^3
N_MD_LATTICE, N_MD_AMG, N_MD_ELEM, N_MD_PULSE, N_MD_K5 = 128, 64, 48, 1024, 64
MD_PULSE_T = 0.005


class _ShardList:
    """``config.shard_devices()`` returns ``devices`` in the block (the
    routes take their shards from it)."""

    def __init__(self, devices):
        self.devices = list(devices)

    def __enter__(self):
        from fenicssolver_tpu_torch import config

        self.saved = config.shard_devices
        config.shard_devices = lambda: list(self.devices)

    def __exit__(self, *exc):
        from fenicssolver_tpu_torch import config

        config.shard_devices = self.saved


def _md_layouts(cards, shards):
    """The two placements of ``shards`` shards held against each other:
    spread over ``cards`` in contiguous blocks (``config.shard_devices()``'s
    rule) and stacked on ``cards[0]``."""
    spread = [cards[r * len(cards) // shards] for r in range(shards)]
    return {"spread": spread, "stacked": [cards[0]] * shards}


def _md_cases(base, n_lat, n_amg, n_elem, n_pulse, pulse_t, n_k5):
    """The multi-device phase's solves, each ``run(devices) -> (x as numpy,
    iterations or steps, seconds of the solve, its Groups and the bytes
    they copied between devices in the solve, or None, None for K5)``."""
    import numpy as np
    import torch

    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.core.meshgen import perturbed_tet_box
    from fenicssolver_tpu_torch.main import main as run_main
    from fenicssolver_tpu_torch.ops import assembly, geometry
    from fenicssolver_tpu_torch.parallel import ShardedEllipticSolver
    from fenicssolver_tpu_torch.parallel.amg_halo import HaloAMGSolver
    from fenicssolver_tpu_torch.parallel.halo import (
        HaloElementSolver,
        batches_from_form,
    )
    from fenicssolver_tpu_torch.parallel.lattice import LatticeHaloSolver

    f64 = torch.float64

    def timed(fn, groups):
        """fn's result, its seconds and the bytes ``groups`` copied between
        devices during it."""
        c0 = 0 if groups is None else groups.copied
        _sync(base)
        t0 = time.perf_counter()
        out = fn()
        _sync(base)
        sec = time.perf_counter() - t0
        return out, sec, None if groups is None else groups.copied - c0

    coef, b_lat, free_lat = _lattice_system(n_lat, base)

    def lattice(devs):
        ls = LatticeHaloSolver(coef, {"n": (n_lat,) * 3}, devices=devs)
        (x, it), sec, cp = timed(lambda: ls.solve(
            b_lat, free_lat, torch.zeros_like(b_lat), tol=1e-10, maxiter=200),
            ls.groups)
        return x.cpu().numpy(), it, sec, ls.groups, cp

    mesh = perturbed_tet_box(n_amg)
    Va = core.FunctionSpace(mesh, "CG", 1)
    ctx = geometry.build_cell_context(Va, 2, device=base, dtype=f64)
    form = assembly.Form(space=Va, cell_terms=[assembly.CellTerm(
        kernel=poisson_kernel(base, f64), ctx=ctx)])
    form.finalize()
    A_amg, b_amg = assembly.assemble_linear_system(form, dtype=f64)
    dd = assembly.DirichletData(Va.ndof)
    dd.add(Va.facet_dofs(mesh.exterior_facets()), 0.0)
    dd.finalize(device=base, dtype=f64)
    free_amg, ubc_amg = dd.free_mask, dd.u_bc

    def amg(devs):
        hs = HaloAMGSolver(A_amg, Va.dof_coords, free_amg.cpu().numpy(),
                           devices=devs)
        (x, it, _), sec, cp = timed(lambda: hs.solve(
            b_amg, ubc_amg, tol=1e-10, maxiter=300), hs.groups)
        return x.cpu().numpy(), it, sec, hs.groups, cp

    Ve, _, form_e, _, _ = sharded_problem(core, poisson_kernel, n_elem, False,
                                          base, f64)
    form_e.finalize()
    Xe = Ve.dof_coords
    dde = assembly.DirichletData(Ve.ndof)
    dde.add(np.nonzero(np.any((Xe == 0.0) | (Xe == 1.0), axis=1))[0], 0.0)
    dde.finalize(device=base, dtype=f64)
    batches = batches_from_form(form_e, f64)

    def element(devs):
        hs = HaloElementSolver(batches, Xe, Ve.ndof, devices=devs, dtype=f64)
        (x, it), sec, cp = timed(lambda: hs.solve(
            dde.free_mask, dde.u_bc, tol=1e-10, maxiter=4000), hs._lay.groups)
        return x.cpu().numpy(), it, sec, hs._lay.groups, cp

    def explicit(devs):
        with _ShardList(devs):
            solver = run_main(_dist(_pulse_vectorised(pulse_settings(
                core, n_pulse, t_end=pulse_t))), device=base)
        st = solver.last_stepper
        return (solver.state, solver.steps_taken,
                solver.timers.totals["march"], st.groups, st.groups.copied)

    Vk, kernel_k, _, bk, ddk = sharded_problem(core, poisson_kernel, n_k5,
                                               False, base, f64)

    def k5(devs):
        solver = ShardedEllipticSolver(Vk, kernel_k, devices=devs, dtype=f64)
        (x, it), sec, _ = timed(lambda: solver.solve(
            bk, ddk.free_mask, ddk.u_bc, tol=1e-10, maxiter=4000), None)
        return x.cpu().numpy(), it, sec, None, None

    return {
        f"slab lattice GMG-CG UnitCubeMesh({n_lat})": lattice,
        f"sharded AMG-CG (perturbed tets) n = {n_amg}": amg,
        f"HaloElementSolver Poisson UnitCubeMesh({n_elem})": element,
        f"explicit march, acoustic pulse {n_pulse} x {n_pulse}": explicit,
        f"K5 ShardedEllipticSolver Poisson UnitCubeMesh({n_k5})": k5,
    }


def phase_multi_device(cards=None, n_lat=N_MD_LATTICE, n_amg=N_MD_AMG,
                       n_elem=N_MD_ELEM, n_pulse=N_MD_PULSE,
                       pulse_t=MD_PULSE_T, n_k5=N_MD_K5):
    """The distributed layer's shards on several cards in one process
    (``parallel/groups.py``).  With two cards or more (``cards``, default
    every card): each distributed solve (the slab lattice GMG-CG, the
    sharded AMG-CG, ``HaloElementSolver``, the explicit march, K5's
    ``ShardedEllipticSolver``) on SHARDS shards spread over the cards and on
    one shard a card, each held against the same shard count stacked on
    ``cards[0]``: the same iteration (or step) count and the solution bit
    for bit, any difference printed and failed.  Prints ms an iteration
    spread beside stacked, the bytes copied between cards an iteration,
    whether peer access is on, and the launches of K1, K2, K5 and
    ``csr_spmv`` on each card (counted in the wrappers, reset before each
    solve).  With one card: ``config.shard_devices()`` is ``cuda:0`` for
    every shard, and the phase says that it needs two cards."""
    import numpy as np
    import torch

    from fenicssolver_tpu_torch import config
    from fenicssolver_tpu_torch.ops import cuda_kernels
    from fenicssolver_tpu_torch.parallel.groups import Groups

    if cards is None:
        n_cards = torch.cuda.device_count()
        cards = [f"cuda:{i}" for i in range(n_cards)]
        with _Shards(SHARDS):
            placed = config.shard_devices()
        want = [torch.device("cuda", r * n_cards // SHARDS)
                for r in range(SHARDS)]
        check(placed == want, f"shard_devices() placed {SHARDS} shards on "
              f"{[str(d) for d in placed]}, expected {[str(d) for d in want]}")
        if n_cards < 2:
            print(f"[multi-device] one card: shard_devices() puts all "
                  f"{SHARDS} shards on cuda:0 (as before); the phase needs "
                  "two cards or more to run")
            return None
    t_phase = time.perf_counter()
    base = cards[0]
    cases = _md_cases(base, n_lat, n_amg, n_elem, n_pulse, pulse_t, n_k5)
    watched = ("stencil_apply_var", "stencil_apply_const", "element_matvec",
               "csr_spmv")
    out = {}
    for name, run in cases.items():
        for shards in (SHARDS, len(cards)):
            rows = {}
            for how, devs in _md_layouts(cards, shards).items():
                cuda_kernels.reset_launch_counts()
                x, it, sec, groups, copied = run(devs)
                launches = {f"{k}@{i}": v for (k, i), v in sorted(
                    cuda_kernels.LAUNCHES_BY_DEVICE.items()) if k in watched}
                rows[how] = dict(x=x, it=it, sec=sec, launches=launches,
                                 groups=groups, copied=copied)
            sp, st = rows["spread"], rows["stacked"]
            same = sp["it"] == st["it"] and np.array_equal(sp["x"], st["x"])
            diff = (0.0 if sp["x"].shape != st["x"].shape or same
                    else float(np.abs(sp["x"] - st["x"]).max()))
            gr = sp["groups"]
            peer = Groups(_md_layouts(cards, shards)["spread"]).peer_access()
            copied = ("not counted (K5's shards each send their partial to "
                      "devices[0])" if gr is None
                      else f"{sp['copied'] / max(sp['it'], 1):.0f} B an "
                           "iteration")
            print(f"[multi-device] {name}: {shards} shards on "
                  f"{len(set(map(str, _md_layouts(cards, shards)['spread'])))}"
                  f" cards: {sp['it']} iterations, {1e3 * sp['sec'] / max(sp['it'], 1):.3f}"
                  f" ms an iteration; stacked on {base}: {st['it']} iterations, "
                  f"{1e3 * st['sec'] / max(st['it'], 1):.3f} ms an iteration; "
                  f"bit-equal {same} (max abs difference {diff:.3e}); copied "
                  f"between cards {copied}; peer access {peer}; launches on "
                  f"the cards {sp['launches']} (stacked {st['launches']})")
            check(same, f"multi-device {name} on {shards} shards: {sp['it']} "
                  f"against {st['it']} iterations stacked, max abs difference "
                  f"{diff}")
            if str(base).startswith("cuda"):
                check(peer is not None, f"{name}: no peer-access reading")
            out[name, shards] = dict(
                iterations=sp["it"], ms_spread=1e3 * sp["sec"] / max(sp["it"], 1),
                ms_stacked=1e3 * st["sec"] / max(st["it"], 1),
                launches=sp["launches"])
            del rows, sp, st
    print(f"[multi-device] phase {time.perf_counter() - t_phase:.2f} s")
    return out


def measure_amg_setup(device=None, n=N_CANTILEVER):
    """The AMG set-up of the elasticity cantilever's constrained system at
    ``n``, split by level and step.  The steps are timed by wrapping the
    set-up's functions where the imported package has them (``la/amg.py``'s
    strength graph, aggregation, tentative prolongator and l1 estimate;
    ``la/sparse_algebra``'s host and device products), so it times another
    tree of the package as well: import this script from that tree's
    directory.  The rest of a level (the inline power iterations, the copies
    to the device) is printed as ``other``.  A tree whose levels record
    their ``steps`` prints those.  Not part of ``main()``."""
    import fenicssolver_tpu_torch.core as core
    from fenicssolver_tpu_torch.la import amg as amg_mod
    from fenicssolver_tpu_torch.la import sparse_algebra as sa
    from fenicssolver_tpu_torch.ops import assembly
    from fenicssolver_tpu_torch.solvers.linear_elasticity import (
        LinearElasticitySolver,
    )

    V, bcs, _ = cantilever(core, n, 1)
    s = LinearElasticitySolver(elasticity_settings(V, bcs, rtol=1e-8),
                               device=device)
    s.init_solver()
    s.current_step = 0
    form, dd = s.generate_form(0, None, None, s.w_current, s.w_prev)
    A, _ = assembly.assemble_linear_system(form)
    Ah = assembly.constrain_csr(A, dd.free_mask).to_host()
    free = dd.free_mask.cpu().numpy() > 0.5
    B = amg_mod.rigid_body_modes(V.scalar_space.dof_coords, 3)
    del A, form
    steps = {}  # (rows of the level, step) -> seconds
    inside = [False]  # a wrapped function called by another is not timed

    def timed(fn, step):
        def run(M, *args, **kw):
            if inside[0]:
                return fn(M, *args, **kw)
            rows = len(M) if step == "tentative" else M.shape[0]
            inside[0] = True
            t0 = time.perf_counter()
            try:
                out = fn(M, *args, **kw)
                _sync(device)
            finally:
                inside[0] = False
            key = (rows, step)
            steps[key] = steps.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    wrap = [(amg_mod, "_strength_graph", "strength"),
            (amg_mod, "_aggregate", "aggregate"),
            (amg_mod, "_tentative_prolongator", "tentative"),
            (sa, "sp_matmat", "smooth_P"), (sa, "sp_add", "smooth_P"),
            (sa, "rap", "rap"), (sa, "sp_transpose", "rap"),
            (sa, "l1_row_sums", "l1"), (amg_mod, "_estimate_l1_lam", "lam1")]
    saved = [(m, name, getattr(m, name)) for m, name, _ in wrap
             if hasattr(m, name)]
    try:
        for m, name, step in wrap:
            if hasattr(m, name):
                setattr(m, name, timed(getattr(m, name), step))
        M = amg_mod.AMGPreconditioner(Ah, nullspace=B, free_mask=free,
                                      device=s.device)
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    for li, lv in enumerate(M.levels):
        mine = lv.get("steps") or {
            k[1]: v for k, v in steps.items() if k[0] == lv["rows"]}
        other = lv["setup_s"] - sum(mine.values())
        print(f"[amg-setup] level {li}: {lv['rows']} rows, {lv['nnz']} nnz, "
              f"{lv['setup_s']:.2f} s: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in mine.items())
              + f", other {other:.2f}")
    coarse = getattr(M, "coarse_steps", None) or {
        k[1]: v for k, v in steps.items() if k[0] == M.coarse_rows}
    print(f"[amg-setup] set-up in all {M.setup_seconds:.2f} s; coarsest "
          f"{M.coarse_rows} rows: " + ", ".join(
              f"{k} {v:.2f}" for k, v in coarse.items()))


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


def main(argv=None):
    """All phases on one card (no arguments); with ``--only multi-device``
    the build and ``phase_multi_device`` alone (run it on a machine with
    several cards), with ``--only elbow-3d`` the build and
    ``phase_elbow_3d_large`` alone."""
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="GPU smoke run of the port")
    ap.add_argument("--only", choices=["multi-device", "elbow-3d"], default=None)
    args = ap.parse_args(argv)
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
    if args.only is not None:
        {"multi-device": phase_multi_device,
         "elbow-3d": phase_elbow_3d_large}[args.only]()
        print(f"[done] the {args.only} phase passed on "
              f"{torch.cuda.device_count()} x {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    k2 = phase_k2()
    k1 = phase_k1()
    k1_bf16 = phase_k1_bf16()
    k34 = phase_k3_k4()
    phase_default_device()
    steady = phase_main_path()
    V = steady.pop("V")
    transient = phase_transient(V=V)
    phase_determinism(transient.pop("solver"))
    phase_fast_path(V=V, T_loop=transient.pop("T"))
    lattice_halo = phase_lattice_halo(V=V, T_serial=steady.pop("T"))
    del V
    phase_advection()
    phase_nonlinear()
    phase_save()
    phase_transient_cli()
    phase_dg()
    phase_periodic()
    phase_restart()
    phase_body_source()
    phase_cli()
    phase_amg_setup_repeat()
    elas = phase_elasticity()
    phase_lattice_elasticity(serial=elas)
    spmv, spmv_launches = elas["spmv"], elas["spmv_launches"]
    coarse_launches = elas["coarse_launches"]
    del elas
    phase_modal()
    phase_amg_scalar()
    phase_wave()
    phase_maxwell()
    phase_elasticity_cli()
    phase_hyperelastic()
    phase_contact()
    phase_plasticity()
    phase_large_deformation()
    phase_elastodynamics()
    phase_adjoint()
    drag, _ = phase_ns_dfg()
    phase_ns_transient()
    phase_ns_ipcs(drag_ref=drag)
    phase_ns_coupled()
    phase_ns_dg()
    phase_compressible()
    phase_fsi()
    phase_distributed_one_shard()
    phase_halo()
    phase_amg_halo()
    phase_explicit()
    phase_distributed_fsi()
    lat = phase_lattice()
    bench_bf16 = phase_bench_bf16()
    unstr = phase_bench_unstructured()
    csr = phase_csr()
    k5 = phase_k5()
    shard = phase_sharded()
    phase_multi_device()
    measured = {
        "stencil_apply_var": (k1, lat["launches"]["stencil_apply_var"]),
        "stencil_apply_var_bf16": (
            k1_bf16, bench_bf16["launches"]["stencil_apply_var_bf16"]),
        "stencil_apply_const": (k2, transient["launches"]),
        "p1_stiffness_sym": (k34["p1_stiffness_sym"],
                             lat["launches"]["p1_stiffness_sym"]),
        "p1_stiffness": (k34["p1_stiffness"], csr["launches"]["p1_stiffness"]),
        "element_matvec": (k5, shard["launches"]),
        "csr_spmv": (spmv, spmv_launches),
    }
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches,
        "lattice_launches": lattice_halo["launches"].get(name, 0),
        "bench_bf16_launches": bench_bf16["launches"].get(name, 0),
        "bench_unstructured_launches": unstr["launches"].get(name, 0),
        "lattice_max_abs_err": lattice_halo["max_abs_err"].get(name),
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "library_case": m["library_case"],
        "library_kernel_ms": m["library_kernel_ms"],
    } for name, (m, launches) in measured.items()]}
    coarse = spmv.get("coarsest")
    if coarse is not None:  # csr_spmv's second case: the stalled level's A
        next(k for k in kernels["kernels"]
             if k["name"] == "csr_spmv")["stalled_coarsest_A"] = {
            "launches": coarse_launches,
            **{k: coarse[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}}
    print(f"[done] all phases passed on {card}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
