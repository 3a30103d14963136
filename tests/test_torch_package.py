"""fenicssolver_tpu_torch package rules: no JAX in the port, the device and
dtype policy, and loud failures for what the port does not cover yet."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

from fenicssolver_tpu_torch import config  # noqa: E402
from fenicssolver_tpu_torch.core import (  # noqa: E402
    FunctionSpace,
    MixedFunctionSpace,
    UnitCubeMesh,
    UnitSquareMesh,
    VectorFunctionSpace,
)
from tests.torch_cpu import on_the_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fenicssolver_tpu_torch")

SLICE_MODULES = [
    "fenicssolver_tpu_torch",
    "fenicssolver_tpu_torch.config",
    "fenicssolver_tpu_torch.native",
    "fenicssolver_tpu_torch.interop",
    "fenicssolver_tpu_torch.main",
    "fenicssolver_tpu_torch.core",
    "fenicssolver_tpu_torch.core.elements",
    "fenicssolver_tpu_torch.core.expression",
    "fenicssolver_tpu_torch.core.function",
    "fenicssolver_tpu_torch.core.mesh",
    "fenicssolver_tpu_torch.core.spaces",
    "fenicssolver_tpu_torch.core.subdomain",
    "fenicssolver_tpu_torch.io.meshio",
    "fenicssolver_tpu_torch.io.checkpoint",
    "fenicssolver_tpu_torch.ops.pointlocate",
    "fenicssolver_tpu_torch.ops.structured",
    "fenicssolver_tpu_torch.ops.geometry",
    "fenicssolver_tpu_torch.ops.assembly",
    "fenicssolver_tpu_torch.ops.cuda_kernels",
    "fenicssolver_tpu_torch.ops.stencil_assembly",
    "fenicssolver_tpu_torch.lattice_poisson",
    "fenicssolver_tpu_torch.parallel",
    "fenicssolver_tpu_torch.parallel.partition",
    "fenicssolver_tpu_torch.parallel.sharding",
    "fenicssolver_tpu_torch.la.sparse",
    "fenicssolver_tpu_torch.la.direct",
    "fenicssolver_tpu_torch.la.krylov",
    "fenicssolver_tpu_torch.la.newton",
    "fenicssolver_tpu_torch.la.gmg",
    "fenicssolver_tpu_torch.utils.timers",
    "fenicssolver_tpu_torch.solvers.solver_base",
    "fenicssolver_tpu_torch.solvers.scalar_transport",
    "fenicssolver_tpu_torch.solvers.scalar_transport_dg",
    "fenicssolver_tpu_torch.solvers.fast_paths",
    "fenicssolver_tpu_torch.compat",
    "fenicssolver_tpu_torch.core.meshgen",
    "fenicssolver_tpu_torch.ops.functional",
    "fenicssolver_tpu_torch.utils.plotting",
    "fenicssolver_tpu_torch.la.sparse_algebra",
    "fenicssolver_tpu_torch.la.amg",
    "fenicssolver_tpu_torch.la.lobpcg",
    "fenicssolver_tpu_torch.solvers.linear_elasticity",
    "fenicssolver_tpu_torch.solvers.maxwell",
    "fenicssolver_tpu_torch.solvers.wave",
]


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fenicssolver_tpu' or m.startswith('fenicssolver_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("FST_")}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice_modules_cover_the_package():
    """Every module of the package is in the import check above."""
    found = set()
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py") and fn != "__main__.py":
                rel = os.path.relpath(os.path.join(root, fn), REPO)[:-3]
                found.add(rel.replace(os.sep, ".").removesuffix(".__init__"))
    listed = set(SLICE_MODULES) | {
        m.rsplit(".", 1)[0] for m in SLICE_MODULES if m.count(".") > 1}
    assert not sorted(found - listed), sorted(found - listed)


def test_no_source_file_imports_jax_or_the_reference():
    pat = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+fenicssolver_tpu\b(?!_torch)"
        r"|from\s+fenicssolver_tpu\b(?!_torch))",
        re.M,
    )
    offenders = []
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                with open(path, encoding="utf-8") as f:
                    if pat.search(f.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


def test_cuda_device_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not apply")
    monkeypatch.setenv("FST_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        config.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        config.resolve_device("cuda:0")
    from fenicssolver_tpu_torch.main import load_settings, main

    settings = load_settings(os.path.join(REPO, "data", "TestHeatTransfer.json"))
    with pytest.raises(RuntimeError, match="cuda"):
        main(settings)


def test_device_and_dtype_policy(monkeypatch):
    """The card unless the caller asks for the CPU; float64 unless
    FST_X32=1."""
    monkeypatch.delenv("FST_DEVICE", raising=False)
    monkeypatch.delenv("FST_X32", raising=False)
    if torch.cuda.is_available():
        assert config.resolve_device() == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            config.resolve_device()
    assert config.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("FST_DEVICE", "cpu")
    assert config.resolve_device() == torch.device("cpu")
    assert config.default_float() == torch.float64
    monkeypatch.setenv("FST_X32", "1")
    assert config.default_float() == torch.float32
    with pytest.raises(ValueError):
        config.resolve_device("meta")


ENTRY_POINTS = ["lattice_cli", "lattice_module", "run_stencil", "run_csr",
                "main", "module", "solver", "sharded", "box_geometry"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With FST_DEVICE unset and no device=, every entry point asks for the
    card: without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not apply")
    monkeypatch.delenv("FST_DEVICE", raising=False)
    case = os.path.join(REPO, "data", "TestHeatTransfer.json")
    if entry in ("module", "lattice_module"):
        args = ([case] if entry == "module" else ["--n", "4"])
        mod = ("fenicssolver_tpu_torch" if entry == "module"
               else "fenicssolver_tpu_torch.lattice_poisson")
        env = {k: v for k, v in os.environ.items() if k != "FST_DEVICE"}
        proc = subprocess.run([sys.executable, "-m", mod, *args], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert "RuntimeError" in proc.stderr and "cuda" in proc.stderr
        return
    from fenicssolver_tpu_torch import lattice_poisson
    from fenicssolver_tpu_torch.main import load_settings, main
    from fenicssolver_tpu_torch.ops.stencil_assembly import box_geometry
    from fenicssolver_tpu_torch.parallel import ShardedEllipticSolver
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    calls = {
        "lattice_cli": lambda: lattice_poisson.main(["--n", "4"]),
        "run_stencil": lambda: lattice_poisson.run_stencil(4),
        "run_csr": lambda: lattice_poisson.run_csr(4),
        "main": lambda: main(load_settings(case)),
        "solver": lambda: ScalarTransportSolver(load_settings(case)),
        "sharded": lambda: ShardedEllipticSolver(
            FunctionSpace(UnitCubeMesh(2, 2, 2), "CG", 1), lambda *a: None),
        "box_geometry": lambda: box_geometry((2, 2, 2)),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


#: chip_smoke's byte model at the shapes of the kernel table in PERF.md:
#: (kernel, its bytes function and arguments, type, bytes)
BYTE_MODEL = [
    ("K2", "k2_bytes", ((129, 129, 129), 8), "float64", 51_520_536),
    ("K1", "k1_bytes", ((129, 129, 129), 4), "float32", 154_561_608),
    ("K3", "k3_bytes", (6 * 128**3, 4), "float32", 1_006_632_960),
    ("K4", "k4_bytes", (6 * 128**3, 8), "float64", 2_617_245_696),
    ("K5", "k5_bytes", (6 * 128**3, 8), "float64", 2_415_919_104),
]


@pytest.mark.parametrize("kernel,fn,args,dtype,nbytes", BYTE_MODEL,
                         ids=[b[0] for b in BYTE_MODEL])
def test_chip_smoke_byte_model(kernel, fn, args, dtype, nbytes):
    """Each input byte read once, each output byte written once; the bound
    is bytes over the data-sheet HBM rate (operations are far below)."""
    import chip_smoke

    assert getattr(chip_smoke, fn)(*args) == nbytes
    flops = (chip_smoke.stencil_flops(args[0]) if kernel in ("K1", "K2")
             else getattr(chip_smoke, f"{kernel.lower()}_flops")(args[0]))
    ms, by = chip_smoke.bound(nbytes, flops, dtype)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


def _settings(V, **extra):
    s = {
        "scalar_name": "temperature", "function_space": V, "mesh": None,
        "boundary_conditions": {},
        "material": {"density": 1000, "specific_heat_capacity": 4200,
                     "thermal_conductivity": 0.6},
        "solver_settings": {
            "transient_settings": {"transient": False},
            "reference_values": {},
            "solver_parameters": {"relative_tolerance": 1e-10},
        },
        "report_settings": {"logging_level": 40},
    }
    s.update(extra)
    return s


def _feature_settings(change):
    from fenicssolver_tpu_torch.core import AutoSubDomain, near

    V = FunctionSpace(UnitSquareMesh(4, 4), "CG", 1)
    bottom = AutoSubDomain(lambda x: near(x[1], 0.0))
    s = _settings(V, boundary_conditions={
        "cold": {"boundary": bottom, "boundary_id": 1, "type": "Dirichlet",
                 "value": 300.0}})
    sp = s["solver_settings"]["solver_parameters"]
    if change == "transient":
        s["solver_settings"]["transient_settings"] = {
            "transient": True, "starting_time": 0, "time_step": 0.1,
            "ending_time": 0.3}
    elif change == "advection":
        s["convective_velocity"] = (1.0, 0.0)
    elif change == "radiation":
        s["radiation_settings"] = {"ambient_temperature": 300.0}
    elif change == "nonlinear":
        s["material"]["thermal_conductivity"] = lambda T: 1.0 + 0.0 * T
    elif change == "amg":
        sp["preconditioner"] = "amg"
    elif change == "distributed":
        sp["distributed"] = True
    elif change == "point_source":
        s["point_source"] = [((0.5, 0.5), 1.0)]
    elif change == "restart_file":
        s["initial_values"] = {"temperature": os.path.join(REPO, "data",
                                                           "mesh.xml")}
    return s


@pytest.mark.parametrize("change", ["distributed", "restart_file"])
def test_unported_features_raise(change):
    """Distributed solves wait for their module; a restart file is read by
    io/checkpoint.py now, which takes ``.npz`` files only."""
    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    error, match = ((ValueError, r"\.npz") if change == "restart_file" else
                    (NotImplementedError, "fenicssolver_tpu_torch"))
    with pytest.raises(error, match=match):
        ScalarTransportSolver(_feature_settings(change)).solve()


@pytest.mark.parametrize(
    "change", ["transient", "advection", "radiation", "nonlinear", "point_source",
               "amg"]
)
def test_formerly_unported_features_run(change):
    """What raised before the scalar extensions and ``la/amg.py`` were ported
    now solves."""
    import numpy as np

    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    solver = ScalarTransportSolver(_feature_settings(change))
    T = solver.solve().values
    assert np.isfinite(T).all()
    dofs = solver.function_space.facet_dofs(solver.boundary_facet_ids(1))
    assert dofs.size and np.allclose(T[dofs], 300.0)


def _periodic_x():
    """A periodic domain: x = 0 is the master boundary, x = 1 maps onto it."""
    from fenicssolver_tpu_torch.core import SubDomain, near

    class PeriodicX(SubDomain):
        def inside(self, x, on_boundary):
            return near(x[0], 0.0)

        def map(self, x, y):
            y[:] = x
            y[0] = x[0] - 1.0

    return PeriodicX()


@pytest.mark.parametrize(
    "what", ["xdmf", "hdf5", "hdf5_solver", "fast_path_ns",
             "fast_path_elasticity", "fast_path_ipcs"]
)
def test_unported_spaces_and_readers_raise(what, tmp_path):
    with pytest.raises(NotImplementedError, match="fenicssolver_tpu_torch") as e:
        if what in ("xdmf", "hdf5"):
            from fenicssolver_tpu_torch.io import meshio

            meshio.read_mesh(str(tmp_path / ("m.xdmf" if what == "xdmf"
                                             else "m.h5")))
        elif what == "hdf5_solver":
            from fenicssolver_tpu_torch.solvers.scalar_transport import (
                ScalarTransportSolver,
            )

            path = tmp_path / "m.h5"
            path.write_bytes(b"")
            ScalarTransportSolver(_settings(None, mesh=str(path)))
        else:
            from fenicssolver_tpu_torch.solvers import fast_paths

            {"fast_path_ns": fast_paths.compile_transient_ns,
             "fast_path_elasticity":
                 fast_paths.compile_transient_elasticity_dynamics,
             "fast_path_ipcs": fast_paths.compile_transient_ns_ipcs,
             }[what](None, 0.1, 1)
    if what in ("xdmf", "hdf5", "hdf5_solver"):
        assert "io/meshio.py" in str(e.value) and "h5py" in str(e.value)


def _raised_module_names():
    """The ``(file, module)`` pairs of every "it comes with <module>" message
    in the package's sources, with the solvers ``main.py`` lists as waiting."""
    from fenicssolver_tpu_torch import main as tmain

    pairs = [("main.py", m) for m in tmain._NOT_PORTED.values()]
    pat = re.compile(r'"((?:solvers|la|core|ops|io|utils|parallel)/[\w./]*)')
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn), encoding="utf-8") as f:
                    src = f.read()
                for block in re.findall(
                        r"(?:not_ported|_waits_for)\((.*?)\)", src, re.S):
                    pairs += [(fn, m) for m in pat.findall(block)]
    return pairs


def test_remaining_errors_name_modules_that_are_still_missing():
    """No ``NotImplementedError`` names a module that the port now has, and
    each one left names a module of the reference (or ``parallel/``, whose
    distributed layer waits, or ``io/meshio.py``'s HDF5 readers)."""
    pairs = _raised_module_names()
    assert len(pairs) >= 12
    ref = os.path.join(REPO, "fenicssolver_tpu")
    for fn, module in pairs:
        assert os.path.exists(os.path.join(ref, module)), (fn, module)
        if module in ("parallel/", "io/meshio.py"):
            continue  # there in part: ranks and the h5py readers wait
        assert not os.path.exists(os.path.join(PKG, module)), (fn, module)
    waiting = {m for _, m in pairs}
    assert not waiting & {"la/amg.py", "la/lobpcg.py", "core/spaces.py",
                          "solvers/linear_elasticity.py", "solvers/maxwell.py",
                          "solvers/wave.py", "utils/plotting.py"}


@pytest.mark.parametrize("name", ["LinearElasticitySolver", "MaxwellEMSolver",
                                  "WavePropagationSolver"])
def test_main_no_longer_lists_the_ported_solvers(name):
    import fenicssolver_tpu_torch as fst
    from fenicssolver_tpu_torch import main as tmain

    assert name not in tmain._NOT_PORTED
    assert getattr(fst, name).__name__ == name
    with pytest.raises(NotImplementedError, match="solvers/navier_stokes.py"):
        tmain.main({"solver_name": "NavierStokesSolver"})


@pytest.mark.parametrize("what", ["P2_periodic", "DG", "vector_periodic",
                                  "vector_P2", "vector_sub", "mixed"])
def test_formerly_unported_spaces_build(what):
    """Periodic and DG spaces, vector spaces above P1, component views and
    mixed spaces, which raised before, are built now."""
    mesh = UnitCubeMesh(2, 2, 2)
    if what == "vector_P2":
        V = VectorFunctionSpace(mesh, "CG", 2)
        assert V.ndof == 3 * 125 and V.ndof_el == 30
    elif what == "vector_sub":
        V = VectorFunctionSpace(mesh, "CG", 1)
        assert list(V.sub(2).global_dofs([0, 1])) == [2, 5]
    elif what == "mixed":
        W = MixedFunctionSpace([VectorFunctionSpace(mesh, "CG", 2),
                                FunctionSpace(mesh, "CG", 1)])
        assert W.ndof == 375 + 27 and W.slice_of(1) == slice(375, 402)
    elif what == "P2_periodic":
        V = FunctionSpace(mesh, "CG", 2, constrained_domain=_periodic_x())
        assert len(V.periodic_slaves) == 25  # 9 vertices + 16 edges at x = 1
    elif what == "DG":
        V = FunctionSpace(mesh, "DG", 1)
        assert V.ndof == 4 * mesh.num_cells() and V.family == "DG"
        with pytest.raises(NotImplementedError, match="weakly"):
            V.facet_dofs([0])
    else:
        V = VectorFunctionSpace(mesh, "CG", 1, constrained_domain=_periodic_x())
        assert len(V.periodic_slaves) == 27
        assert (V._periodic_master[V.periodic_slaves] % 3
                == V.periodic_slaves % 3).all()


def test_lazy_exports():
    import fenicssolver_tpu_torch as fst

    assert fst.ScalarTransportSolver.__name__ == "ScalarTransportSolver"
    assert issubclass(fst.SolverError, Exception)
    with pytest.raises(AttributeError):
        fst.NoSuchSolver  # noqa: B018
    assert fst.__version__


def test_chip_smoke_fails_without_a_card():
    """The GPU smoke script exits non-zero and prints no result line when
    no CUDA device is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
