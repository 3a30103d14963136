"""P1 Poisson on the unit cube's Kuhn lattice through the port's stencil
path, one load case a request.

The program has no entry that takes a right-hand side on this path
(``fenicssolver_tpu_torch.lattice_poisson.run_stencil`` assembles and
solves its one fixed load), so this driver composes the path as
``run_stencil`` does (``fenicssolver_tpu_torch/lattice_poisson.py``,
``run_stencil`` and ``_free3``), copying its glue: the boundary mask
``fr``, and the masked operator ``fr * K1(fr * x) + (1 - fr) * x`` (three
lines) around ``cuda_kernels.stencil_apply_var``.  Set-up: ``box_geometry``,
``gmg.build_gmg`` and ``assemble_stencil`` (K3 in ``sym`` mode).  A request
makes its load scaling ``s`` (the traffic's field at the vertices, a few
elementwise products on the device) and solves ``fr * (b3 * s)`` by
``la/krylov.cg`` preconditioned by ``gmg.preconditioner``, from zero, to
``|r| <= tol |b|``.

Configuration keys: ``n``, ``dtype``, ``assembly``, ``tol``, ``maxiter``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch

from harness.fields import lattice_coords


class System:
    def __init__(self, cfg, device):
        from fenicssolver_tpu_torch.la import gmg
        from fenicssolver_tpu_torch.la.krylov import cg
        from fenicssolver_tpu_torch.ops import cuda_kernels
        from fenicssolver_tpu_torch.ops.stencil_assembly import (
            assemble_stencil,
            box_geometry,
        )

        self.device = device
        n = int(cfg["n"])
        self.dtype = dtype = getattr(torch, cfg["dtype"])
        self.tol, self.maxiter = float(cfg["tol"]), int(cfg["maxiter"])
        self.cg = cg
        JinvT, detJ = box_geometry((n, n, n), dtype=dtype, device=device)
        fr = torch.zeros((n + 1,) * 3, dtype=dtype, device=device)
        fr[1:-1, 1:-1, 1:-1] = 1.0
        omf = 1.0 - fr
        self.G = gmg.build_gmg(n, n, n, dtype=dtype, device=device)
        coef, b3 = assemble_stencil(JinvT, detJ, (n, n, n), mode=cfg["assembly"])
        del JinvT, detJ
        self.fr, self.b3 = fr, b3
        self.ndof = fr.numel()
        shape3 = fr.shape
        self._span = lambda name: nullcontext()
        vcycle = gmg.preconditioner(self.G)

        def matvec(x):
            with self._span("K1 operator"):
                x3 = x.view(shape3)
                return torch.addcmul(
                    cuda_kernels.stencil_apply_var(x3, coef, fr), omf, x3
                ).view(-1)

        def precondition(r):
            with self._span("V-cycle"):
                return vcycle(r)

        self.matvec, self.M = matvec, precondition
        self.coords = lattice_coords(n)
        self.x = None

    def request(self, field):
        s3 = field.on_lattice_torch(self.coords, self.dtype, self.device)
        rhs = (self.fr * (self.b3 * s3)).reshape(-1)
        t0 = time.perf_counter()
        x, iters, _ = self.cg(self.matvec, rhs, M=self.M, tol=self.tol,
                              maxiter=self.maxiter)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.x = x
        return {"iterations": int(iters), "krylov_s": time.perf_counter() - t0}

    def answer(self):
        return self.x

    def to_lattice(self, x):
        return x.to(torch.float64).cpu().numpy()

    @contextmanager
    def traced(self, span):
        """The operator and the preconditioner each inside a benchmark
        span."""
        self._span = span
        try:
            yield
        finally:
            self._span = lambda name: nullcontext()

    def close(self):
        self.G = self.fr = self.b3 = self.x = None
        self.matvec = self.M = None
