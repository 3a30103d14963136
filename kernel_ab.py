#!/usr/bin/env python3
"""A/B of the hand-written kernels of two source trees on one NVIDIA card,
in one process: ``csr_spmv`` (``csrc/csr_spmv.cu``) and the lattice
stencils K1, K1-bf16 and K2 (``csrc/stencil.cu``).

    python3 kernel_ab.py --other DIR

``DIR`` holds another tree's ``fenicssolver_tpu_torch/csrc/`` (for
example a parent commit unpacked by ``git archive`` into the gitignored
``_checkout/``).  Both trees' sources are built by
``cuda_kernels.build``, one ``nvcc`` each, all started together, loaded
by the port's library loaders and called through their C interfaces (the
same in both trees) on the same inputs:

- ``csr_spmv`` on the operators of the elasticity cantilever's AMG
  hierarchy (1,048,707 dofs: level 0's A, A on 6 columns, R and P, the
  stalled coarsest level's A) and of ``run_unstructured(100)``'s SA-AMG
  hierarchy (every level's A, R and P, f32): each library at each group
  size it is built for, twice bit-equal, the bits of equal group sizes
  compared across libraries, against cuSPARSE at the phase tolerances of
  ``chip_smoke.py``; then timed with CUDA events, L2 flushed, in turns
  (other, this, this, other) at the other tree's default group and this
  tree's plan, beside every group of this tree and cuSPARSE;
- K1-bf16, the f32 K1 and the f64 K2 at 129^3 all-Dirichlet: the bits
  compared across libraries, timed in turns likewise.

Prints one line a case and writes everything as JSON to ``--out`` (by
default ``kernel_ab.json`` in the gitignored build directory).  Needs a
CUDA device; imports only the port and ``chip_smoke.py``'s helpers.
"""

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SOURCES = ("csr_spmv", "stencil")
#: the checks that failed (the run goes on and exits 1)
FAILED = []


class Lib:
    """One tree's csr_spmv and stencil libraries, as the port's loaders
    build and declare them."""

    def __init__(self, tag, csrc):
        from fenicssolver_tpu_torch.ops import cuda_kernels

        self.tag = tag
        self.spmv_lib = cuda_kernels._csr_spmv_lib(csrc)
        self.st = cuda_kernels._stencil_lib(csrc)

    def spmv(self, args, group):
        import torch

        ip, ix, data, x, shape = args
        m = 1 if x.dim() == 1 else x.shape[1]
        y = torch.empty((shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        fn = (self.spmv_lib.fst_csr_spmv_f64 if x.dtype == torch.float64
              else self.spmv_lib.fst_csr_spmv_f32)
        rc = fn(ip.data_ptr(), ix.data_ptr(), data.data_ptr(), x.data_ptr(),
                y.data_ptr(), shape[0], m, group,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.tag} csr_spmv group {group}: error {rc}")
        return y

    def stencil(self, x, f, coef, taps=None):
        import numpy as np
        import torch

        from fenicssolver_tpu_torch.ops import cuda_kernels

        y = torch.empty_like(x)
        t = None if taps is None else np.ascontiguousarray(taps, np.float64)
        rc = self.st.fst_stencil_apply(
            cuda_kernels._STENCIL_DTYPE[x.dtype], x.data_ptr(),
            None if f is None else f.data_ptr(),
            None if coef is None else coef.data_ptr(), y.data_ptr(), *x.shape,
            None if t is None else t.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.tag} stencil: error {rc}")
        return y

    def plan(self, x, masked, var):
        from fenicssolver_tpu_torch.ops import cuda_kernels

        out = (ctypes.c_int * 16)()
        rc = self.st.fst_stencil_plan(cuda_kernels._STENCIL_DTYPE[x.dtype],
                                      int(masked), int(var), *x.shape, out)
        return None if rc else out[:9]


def elasticity_operators(n=cs.N_CANTILEVER):
    """The cantilever's AMG hierarchy (full size by default): {name:
    csr_spmv args}."""
    import torch

    from fenicssolver_tpu_torch.la import amg as amg_mod

    Ah, free, B, _, _, dev = cs.cantilever_system(None, n)
    amg = amg_mod.AMGPreconditioner(Ah, nullspace=B, free_mask=free,
                                    device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)

    def args(ip, ix, data, shape, cols=None):
        x = torch.randn((shape[1],) if cols is None else (shape[1], cols),
                        generator=gen, dtype=data.dtype, device=data.device)
        return (ip, ix, data, x, tuple(shape))

    lv = amg.levels[0]
    A, p = lv["A"], lv["A"].pattern
    ops = {"elasticity level 0 A": args(p.indptr, p.indices, A.data, A.shape),
           "elasticity level 0 A, 6 columns": args(p.indptr, p.indices,
                                                   A.data, A.shape, 6)}
    for k in ("R", "P"):
        M = lv[k]
        ops[f"elasticity level 0 {k}"] = args(M.indptr, M.indices, M.data,
                                              M.shape)
    if amg._coarse_cheb is not None:  # the stalled level
        C = amg._coarse_cheb["A"]
        ops["elasticity coarsest A"] = args(C.pattern.indptr,
                                            C.pattern.indices, C.data, C.shape)
    return ops


def unstructured_operators(n=100):
    """``run_unstructured(n)``'s hierarchy: {name: csr_spmv args}."""
    import torch

    from fenicssolver_tpu_torch.lattice_poisson import run_unstructured

    r = run_unstructured(n)
    ops = {}
    for li, m in enumerate(r["solver"].levels):
        for k in ("A", "R", "P"):
            M = m[k]
            gen = torch.Generator(device=M.data.device).manual_seed(7)
            x = torch.randn(M.shape[1], generator=gen, dtype=M.data.dtype,
                            device=M.data.device)
            ops[f"unstructured level {li} {k}"] = (M.indptr, M.indices,
                                                   M.data, x, tuple(M.shape))
    return ops


def ab_spmv(name, args, other, this):
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels

    ip, ix, data, x, shape = args
    m = 1 if x.dim() == 1 else x.shape[1]
    nnz = data.numel()
    plan = cuda_kernels.spmv_plan(shape[0], shape[1], nnz, m)
    mean = nnz / shape[0]
    old = next((g for g in (4, 8, 16, 32) if 8 * g * m >= mean), 32)
    dname = str(data.dtype).replace("torch.", "")
    tol = cs.TOL[dname]
    ref = cuda_kernels.csr_spmv_reference(*args)
    scale = float(ref.abs().max()) or 1.0
    rec = {"shape": shape, "nnz": nnz, "columns": m, "dtype": dname,
           "plan": plan, "other_default": old, "groups": {}}
    lib_outs = {}
    for lib in (other, this):
        groups = (4, 8, 16, 32) if lib is other else cuda_kernels.SPMV_GROUPS
        for g in groups:
            y1, y2 = lib.spmv(args, g), lib.spmv(args, g)
            torch.cuda.synchronize()
            rel = float((y1 - ref).abs().max()) / scale
            if not torch.equal(y1, y2) or rel > tol:
                FAILED.append(f"{name} {lib.tag} group {g}: twice equal "
                              f"{torch.equal(y1, y2)}, rel {rel} (tol {tol})")
                print(f"[ab] FAILED {FAILED[-1]}", flush=True)
            lib_outs[(lib.tag, g)] = y1
    for g in (4, 8, 16, 32):
        rec["groups"][f"bits equal other/this at {g}"] = torch.equal(
            lib_outs[("other", g)], lib_outs[("this", g)])
    del lib_outs
    nbytes = cs.spmv_bytes(shape[0], shape[1], nnz, data.element_size()) + (
        (m - 1) * (shape[0] + shape[1]) * data.element_size())
    rec["bound_ms"] = cs.bound(nbytes, 2 * nnz * m, dname)[0]

    def t(lib, g):
        return cs.time_ms(lambda: lib.spmv(args, g), flush=True)

    turns = [t(other, old), t(this, plan), t(this, plan), t(other, old)]
    rec["turns_ms"] = {"other": [turns[0], turns[3]],
                       "this": [turns[1], turns[2]]}
    rec["this_ms"] = {g: t(this, g) for g in cuda_kernels.SPMV_GROUPS}
    rec["cusparse_ms"] = cs.time_ms(
        lambda: cuda_kernels.csr_spmv_reference(*args), flush=True)
    bits = all(v for v in rec["groups"].values())
    print(f"[ab] csr_spmv {name} {shape} x {m}, {nnz} nnz ({mean:.1f} a row), "
          f"{dname}: plan {plan} (other's {old}); turns other/this/this/other "
          + ", ".join(f"{v:.4f}" for v in turns) + " ms; this by group "
          + ", ".join(f"{g} {v:.4f}" for g, v in rec["this_ms"].items())
          + f"; cuSPARSE {rec['cusparse_ms']:.4f}; bound {rec['bound_ms']:.4f};"
          f" bits equal to other's at 4-32: {bits}", flush=True)
    return rec


def ab_stencil(other, this, n=cs.N_MAIN):
    import numpy as np
    import torch

    shape = (n + 1,) * 3
    f_np = dict(cs.stencil_masks(shape))["all-dirichlet"]
    out = {}
    x, c = cs._bf16_operands(shape, "cuda", 3)
    f = torch.as_tensor(f_np, device="cuda").to(torch.bfloat16)
    taps = np.random.default_rng(5).standard_normal(15)
    cases = {
        "k1-bf16": ((x, f, c, None), cs.k1_bf16_bytes(shape)),
        "k1 f32": ((x.float(), f.float(), c.float(), None),
                   cs.k1_bytes(shape, 4)),
        "k2 f64": ((x.double(), f.double(), None, taps),
                   cs.k2_bytes(shape, 8)),
    }
    for name, (a, nbytes) in cases.items():
        libs = [other, this]
        ys = {lib.tag: lib.stencil(*a) for lib in libs}
        torch.cuda.synchronize()
        equal = {k: torch.equal(ys["other"], y) for k, y in ys.items()}
        del ys

        def t(lib):
            return cs.time_ms(lambda: lib.stencil(*a), flush=True)

        turns = [t(other), t(this), t(this), t(other)]
        plans = {lib.tag: lib.plan(a[0], True, a[2] is not None) for lib in libs}
        bound = cs.bound(nbytes, 0, "float32")[0]
        out[name] = {"turns_ms": {"other": [turns[0], turns[3]],
                                  "this": [turns[1], turns[2]]},
                     "bits_equal_other": equal,
                     "plans": plans, "bound_ms": bound}
        print(f"[ab] {name} {shape} all-dirichlet: turns other/this/this/other "
              + ", ".join(f"{v:.4f}" for v in turns) + " ms"
              + f"; bound {bound:.4f} ms; bits equal to other's {equal}; "
              f"plans {plans}", flush=True)
    return out


def main():
    import torch

    from fenicssolver_tpu_torch.ops import cuda_kernels

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (holds fenicssolver_tpu_torch/csrc)")
    ap.add_argument("--out",
                    default=os.path.join(cuda_kernels.BUILD_DIR, "kernel_ab.json"),
                    help="where the JSON record goes")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    card = cs.phase_device()
    trees = {"other": os.path.join(os.path.abspath(a.other),
                                   "fenicssolver_tpu_torch", "csrc"),
             "this": cuda_kernels.CSRC_DIR}
    jobs = [(tag, name) for tag in trees for name in SOURCES]
    with ThreadPoolExecutor(len(jobs)) as ex:
        paths = list(ex.map(lambda j: cuda_kernels.build(j[1], trees[j[0]]),
                            jobs))
    for (tag, name), path in zip(jobs, paths):
        for line in cs._ptxas_lines(cuda_kernels.BUILD_INFO[path]["log"]):
            if "csr_spmv" in line or "nv_bfloat16" in line:
                print(f"[ab] ptxas {tag} {name}: {line}")
    other, this = (Lib(tag, csrc) for tag, csrc in trees.items())
    result = {"card": card, "stencil": ab_stencil(other, this), "spmv": {}}
    ops = {**elasticity_operators(), **unstructured_operators()}
    for name, args in ops.items():
        result["spmv"][name] = ab_spmv(name, args, other, this)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(f"[ab] done on {card}; {a.out}; failed: {FAILED or 'none'}")
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
