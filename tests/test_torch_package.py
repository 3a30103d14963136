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
    "fenicssolver_tpu_torch.parallel.groups",
    "fenicssolver_tpu_torch.parallel.partition",
    "fenicssolver_tpu_torch.parallel.sharding",
    "fenicssolver_tpu_torch.parallel.halo",
    "fenicssolver_tpu_torch.parallel.amg_halo",
    "fenicssolver_tpu_torch.parallel.explicit",
    "fenicssolver_tpu_torch.parallel.lattice",
    "fenicssolver_tpu_torch.la.sparse",
    "fenicssolver_tpu_torch.la.direct",
    "fenicssolver_tpu_torch.la.krylov",
    "fenicssolver_tpu_torch.la.newton",
    "fenicssolver_tpu_torch.la.gmg",
    "fenicssolver_tpu_torch.la.gmg_elastic",
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
    "fenicssolver_tpu_torch.solvers.nonlinear_elasticity",
    "fenicssolver_tpu_torch.solvers.navier_stokes",
    "fenicssolver_tpu_torch.solvers.plasticity",
    "fenicssolver_tpu_torch.solvers.large_deformation",
    "fenicssolver_tpu_torch.ops.adjoint",
    "fenicssolver_tpu_torch.solvers.navier_stokes_dg",
    "fenicssolver_tpu_torch.solvers.compressible_ns",
    "fenicssolver_tpu_torch.solvers.fsi",
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


REFERENCE = os.path.join(REPO, "fenicssolver_tpu")

#: public names of the reference that the port leaves out on purpose
LEFT_OUT = {
    # a TPU gather layout: ``spmv: "bell"`` maps to CSR in the port
    "la.block_ell": "*",
    "native": {"build_ell"},
    # the Pallas kernels: their CUDA counterparts are in csrc/
    "ops.pallas_kernels": "*",
    # returns jnp.int32 and has no caller
    "config": {"default_int"},
    # the arrays of the shard_map program (solvers/compressible_ns.py:442);
    # the port's stepper keeps them per device group
    "parallel.explicit": {"HaloExplicitStepper.comm_arrays"},
    # the shard_map V-cycle program (solvers/navier_stokes.py:1573-1617);
    # the port's HaloAMGSolver.vcycle takes its place
    "parallel.amg_halo": {"HaloAMGSolver.vcycle_static",
                          "HaloAMGSolver.level_args", "build_vcycle"},
    # a shard_map axis name
    "parallel.halo": {"AXIS"},
    "parallel.sharding": {"AXIS"},
}


def _public_names(pkg, with_imports):
    """{module: its public names} of a package, read by ``ast``: functions,
    classes, module-level assignments (and, ``with_imports``, names bound by
    an import), each class's public methods with those inherited from
    classes of the package, as ``Class.method``."""
    import ast

    trees = {}
    for root, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                mod = os.path.relpath(path, pkg)[:-3].replace(os.sep, ".")
                with open(path, encoding="utf-8") as f:
                    trees[mod.removesuffix("__init__").rstrip(".")] = ast.parse(f.read())
    classes = {n.name: n for t in trees.values() for n in t.body
               if isinstance(n, ast.ClassDef)}

    def methods(cls, seen):
        out = {n.name for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for b in cls.bases:
            base = getattr(b, "id", getattr(b, "attr", None))
            if base in classes and base not in seen:
                out |= methods(classes[base], seen | {base})
        return out

    names = {}
    for mod, tree in trees.items():
        found = set()
        for n in tree.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                found.add(n.name)
            elif isinstance(n, ast.ClassDef):
                found |= {n.name} | {f"{n.name}.{m}" for m in methods(n, {n.name})}
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                found |= {t.id for t in targets if isinstance(t, ast.Name)}
            elif with_imports and isinstance(n, (ast.Import, ast.ImportFrom)):
                found |= {(a.asname or a.name).split(".")[0] for a in n.names}
        names[mod] = {x for x in found
                      if not any(p.startswith("_") for p in x.split("."))}
    return names


def test_the_port_has_every_public_name_of_the_reference():
    ref = _public_names(REFERENCE, with_imports=False)
    port = _public_names(PKG, with_imports=True)
    missing = {}
    for mod, names in ref.items():
        left_out = LEFT_OUT.get(mod, set())
        if left_out == "*":
            continue
        lacks = sorted(names - port.get(mod, set()) - left_out)
        if lacks:
            missing[mod] = lacks
    assert not missing, missing
    # every exception still names something the reference has
    for mod, left_out in LEFT_OUT.items():
        assert mod in ref and (left_out == "*" or left_out <= ref[mod]), mod


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
                "main", "module", "solver", "sharded", "box_geometry",
                "run_stencil_bf16", "run_unstructured", "lattice_cli_bf16",
                "lattice_cli_unstructured"]


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
        "run_stencil_bf16": lambda: lattice_poisson.run_stencil(4, bf16=True),
        "run_unstructured": lambda: lattice_poisson.run_unstructured(4),
        "lattice_cli_bf16": lambda: lattice_poisson.main(["--n", "4", "--bf16"]),
        "lattice_cli_unstructured": lambda: lattice_poisson.main(
            ["--n", "4", "--format", "unstructured"]),
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
    ("K1-bf16", "k1_bf16_bytes", ((129, 129, 129),), "float32", 77_280_804),
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
             else getattr(chip_smoke, fn.replace("bytes", "flops"))(args[0]))
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
def test_unported_features_raise(change, monkeypatch, caplog):
    """A restart file is read by io/checkpoint.py, which takes ``.npz``
    files only.  ``distributed`` (F4): with one shard the solve logs the
    reference's warning and equals the serial solve; with 8 shards on a
    BoxMesh lattice it takes the reference's route, the sharded lattice GMG
    (``parallel/lattice.py``; it raised until that was ported), and equals
    the serial solve (1e-9; both stop at 1e-10)."""
    import logging

    import numpy as np

    from fenicssolver_tpu_torch.solvers.scalar_transport import (
        ScalarTransportSolver,
    )

    if change == "restart_file":
        with pytest.raises(ValueError, match=r"\.npz"):
            ScalarTransportSolver(_feature_settings(change)).solve()
        return
    monkeypatch.delenv("FST_SHARDS", raising=False)
    serial = ScalarTransportSolver(_feature_settings("none")).solve().values
    s = _feature_settings(change)
    s["report_settings"]["logging_level"] = logging.WARNING
    with caplog.at_level(logging.WARNING):
        dist = ScalarTransportSolver(s).solve().values
    assert "only one device is visible" in caplog.text
    assert np.array_equal(dist, serial)
    cube = FunctionSpace(UnitCubeMesh(16, 16, 16), "CG", 1)
    s = _feature_settings("none")
    s["function_space"], s["body_source"] = cube, 1000.0
    serial = ScalarTransportSolver(s).solve().values
    s = _feature_settings(change)
    s["function_space"], s["body_source"] = cube, 1000.0
    monkeypatch.setenv("FST_SHARDS", "8")
    solver = ScalarTransportSolver(s)
    dist = solver.solve().values
    assert solver.last_preconditioner == "lattice_gmg"
    assert np.linalg.norm(dist - serial) / np.linalg.norm(serial) < 1e-9


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
    "what", ["xdmf", "hdf5", "hdf5_solver", "ns_distributed_newton",
             "ns_distributed_picard"]
)
def test_unported_spaces_and_readers_raise(what, tmp_path, monkeypatch, caplog):
    """What raised before the distributed layer and the readers came: an
    inline-XML XDMF mesh and an HDF5 round trip, each against the JAX
    package's reader of the same file; a solver reading an ``.h5`` mesh
    with its boundary markers (tests/test_solver_base_extras.py's case,
    against the JAX solver); and a distributed NS solve (Newton, Picard)
    with one shard, which logs the reference's warning and equals the
    serial solve bit for bit."""
    import logging

    import numpy as np

    from fenicssolver_tpu.io import meshio as jmeshio
    from fenicssolver_tpu_torch.io import meshio

    if what == "xdmf":
        mesh = UnitSquareMesh(3, 2)
        path = tmp_path / "m.xdmf"
        cells = " ".join(map(str, mesh.cells_array.ravel()))
        xy = " ".join(f"{v:.17g}" for v in mesh.coords.ravel())
        path.write_text(
            '<?xml version="1.0"?>\n<Xdmf Version="3.0"><Domain><Grid>'
            f'<Topology TopologyType="Triangle" NumberOfElements="{mesh.num_cells()}">'
            f'<DataItem Format="XML" Dimensions="{mesh.num_cells()} 3">{cells}'
            '</DataItem></Topology><Geometry GeometryType="XY">'
            f'<DataItem Format="XML" Dimensions="{mesh.num_vertices()} 2">{xy}'
            '</DataItem></Geometry></Grid></Domain></Xdmf>')
        m = meshio.read_mesh(str(path))
        coords, cells = jmeshio.read_xdmf(str(path))
        assert np.array_equal(m.coords, coords)
        assert np.array_equal(m.cells_array, np.sort(cells, axis=1))
        assert np.array_equal(m.cells_array, mesh.cells_array)
    elif what == "hdf5":
        mesh = UnitSquareMesh(3, 3)
        fn = str(tmp_path / "m.h5")
        meshio.write_hdf5(fn, mesh, subdomains=np.arange(mesh.num_cells()))
        got, want = meshio.read_hdf5(fn), jmeshio.read_hdf5(fn)
        for a, b in zip(got[:3], want[:3]):
            assert np.array_equal(a, b)
        assert got[3] is None and want[3] is None
        assert np.array_equal(got[1], mesh.cells_array)
    elif what == "hdf5_solver":
        from fenicssolver_tpu.solvers.scalar_transport import (
            ScalarTransportSolver as JS,
        )
        from fenicssolver_tpu_torch.core import AutoSubDomain, MeshFunction, near
        from fenicssolver_tpu_torch.solvers.scalar_transport import (
            ScalarTransportSolver,
        )
        from tests.test_heat_transfer import base_settings as jbase
        from tests.test_heat_transfer import make_bcs as jbcs
        from tests.test_torch_heat import (DIRICHLET_COLD, DIRICHLET_HOT,
                                           base_settings, make_bcs)

        mesh = UnitSquareMesh(6, 6)
        mf = MeshFunction("size_t", mesh, mesh.tdim - 1)
        AutoSubDomain(lambda x: near(x[1], 1.0)).mark(mf, 1)
        AutoSubDomain(lambda x: near(x[1], 0.0)).mark(mf, 2)
        AutoSubDomain(lambda x: near(x[0], 0.0)).mark(mf, 3)
        fn = str(tmp_path / "m.h5")
        meshio.write_hdf5(fn, mesh, boundaries=mf.values)
        out = []
        for settings, cls, bcs in ((base_settings, ScalarTransportSolver,
                                    make_bcs(DIRICHLET_HOT, DIRICHLET_COLD)),
                                   (jbase, JS, jbcs())):
            s = settings(None, bcs)
            s.update(function_space=None, mesh=fn, fe_degree=1)
            solver = cls(s)
            solver.material["conductivity"] = 0.6
            out.append((solver, np.asarray(solver.solve().values)))
        (solver, T), (_, T_jax) = out
        assert np.array_equal(solver.boundary_facets.values, mf.values)
        T_exact = 300 + 60 * solver.function_space.dof_coords[:, 1]
        assert np.linalg.norm(T - T_exact) / np.linalg.norm(T_exact) < 1e-9
        assert np.linalg.norm(T - T_jax) / np.linalg.norm(T_jax) < 1e-10
    else:
        from fenicssolver_tpu_torch.solvers.navier_stokes import (
            CoupledNavierStokesSolver,
        )
        import fenicssolver_tpu_torch.core as tcore
        from tests.test_torch_navier_stokes import channel

        monkeypatch.delenv("FST_SHARDS", raising=False)
        out = []
        for distributed in (False, True):
            s = channel(tcore, 2, 2)
            s["report_settings"]["logging_level"] = logging.WARNING
            if distributed:
                s["solver_settings"]["solver_parameters"]["distributed"] = True
            solver = CoupledNavierStokesSolver(s)
            solver.using_nonlinear_solver = what.endswith("newton")
            with caplog.at_level(logging.WARNING):
                out.append(solver.solve().values.copy())
        assert "only one device is visible" in caplog.text
        assert np.array_equal(out[0], out[1])


def _raised_module_names():
    """The ``(file, module)`` pairs of every "it comes with <module>" message
    in the package's sources."""
    pairs = []
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
    each one left names a module of the reference that the port lacks."""
    pairs = _raised_module_names()
    # solver_base.py's distributed BoxMesh route raised naming
    # parallel/lattice.py until the sharded lattice GMG was ported
    assert ("solver_base.py", "parallel/lattice.py") not in pairs
    for module in ("parallel/lattice.py", "la/gmg_elastic.py"):
        assert os.path.exists(os.path.join(PKG, module)), module
    ref = os.path.join(REPO, "fenicssolver_tpu")
    for fn, module in pairs:
        assert os.path.exists(os.path.join(ref, module)), (fn, module)
        assert not os.path.exists(os.path.join(PKG, module)), (fn, module)
    waiting = {m for _, m in pairs}
    assert not waiting & {"parallel/", "parallel/halo.py",
                          "parallel/lattice.py", "la/gmg_elastic.py",
                          "parallel/amg_halo.py", "parallel/explicit.py",
                          "io/meshio.py"}
    assert not waiting & {"la/amg.py", "la/lobpcg.py", "core/spaces.py",
                          "solvers/linear_elasticity.py", "solvers/maxwell.py",
                          "solvers/wave.py", "utils/plotting.py",
                          "solvers/nonlinear_elasticity.py",
                          "solvers/plasticity.py",
                          "solvers/large_deformation.py", "ops/adjoint.py",
                          "solvers/navier_stokes.py",
                          "solvers/navier_stokes_dg.py",
                          "solvers/compressible_ns.py", "solvers/fsi.py"}


@pytest.mark.parametrize("name", ["LinearElasticitySolver", "MaxwellEMSolver",
                                  "WavePropagationSolver",
                                  "NonlinearElasticitySolver", "PlasticitySolver",
                                  "LargeDeformationSolver",
                                  "CoupledNavierStokesSolver", "NSDGSolver",
                                  "CompressibleNSSolver", "FSISolver"])
def test_main_no_longer_lists_the_ported_solvers(name):
    import fenicssolver_tpu_torch as fst
    from fenicssolver_tpu_torch import main as tmain

    assert not hasattr(tmain, "_NOT_PORTED")
    assert getattr(fst, name).__name__ == name


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


@pytest.mark.parametrize("name", ["NonlinearElasticitySolver",
                                  "PlasticitySolver", "LargeDeformationSolver",
                                  "NSDGSolver", "CompressibleNSSolver",
                                  "FSISolver"])
def test_new_solvers_dispatch_on_the_card_by_default(name, monkeypatch):
    """``main`` builds the nonlinear solids and the last three solvers with
    the default device: without a card that raises for the card, not for a
    missing port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not apply")
    from fenicssolver_tpu_torch.main import main

    monkeypatch.delenv("FST_DEVICE", raising=False)
    V = VectorFunctionSpace(UnitCubeMesh(1, 1, 1), "CG", 1)
    s = {"solver_name": name, "function_space": V, "mesh": None,
         "boundary_conditions": {},
         "material": {"elastic_modulus": 10.0, "poisson_ratio": 0.3,
                      "yield_strength": 1.0},
         "solver_settings": {"transient_settings": {"transient": True},
                             "reference_values": {}},
         "report_settings": {"logging_level": 40}}
    if name == "FSISolver":
        s = {"solver_name": name, "transient_settings": {"transient": True},
             "participants": [{"solver_domain": "fluidic", "settings": s}]}
    with pytest.raises(RuntimeError, match="cuda"):
        main(s)


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
