"""Deferred-evaluation expression trees for post-processing functionals.

Port of ``fenicssolver_tpu/ops/functional.py`` (host numpy, the same
code).  FenicsSolver's examples assemble UFL functionals like
``assemble(k * dot(grad(T), n) * ds(id))`` for flux checks.  This module
provides that surface: a tiny symbolic layer whose nodes evaluate
numerically at cell/facet quadrature points (host numpy: a post-processing
path, not the solve path).

Supported: Function / grad(Function) / FacetNormal / Constant / numbers,
+ - * / **, dot, inner, sqrt, abs; measures ``dx``/``ds`` with subdomain ids.
"""

from __future__ import annotations

import numbers

import numpy as np

from ..core import elements
from ..core.expression import Constant
from ..core.function import Function
from ..core.spaces import VectorFunctionSpace


class Expr:
    def __mul__(self, o):
        if isinstance(o, Measure):
            return IntegralForm(self, o)
        return BinOp("*", self, _wrap(o))

    def __rmul__(self, o):
        return BinOp("*", _wrap(o), self)

    def __add__(self, o):
        return BinOp("+", self, _wrap(o))

    def __radd__(self, o):
        return BinOp("+", _wrap(o), self)

    def __sub__(self, o):
        return BinOp("-", self, _wrap(o))

    def __rsub__(self, o):
        return BinOp("-", _wrap(o), self)

    def __truediv__(self, o):
        return BinOp("/", self, _wrap(o))

    def __rtruediv__(self, o):
        return BinOp("/", _wrap(o), self)

    def __pow__(self, o):
        return BinOp("**", self, _wrap(o))

    def __neg__(self):
        return BinOp("*", ScalarLeaf(-1.0), self)


class ScalarLeaf(Expr):
    def __init__(self, v):
        self.value = v


class TensorLeaf(Expr):
    def __init__(self, v):
        self.value = np.asarray(v, dtype=np.float64)


class FunctionLeaf(Expr):
    def __init__(self, fn):
        self.fn = fn


class GradLeaf(Expr):
    def __init__(self, fn):
        self.fn = fn


class NormalLeaf(Expr):
    def __init__(self, mesh):
        self.mesh = mesh


class CoordLeaf(Expr):
    def __init__(self, mesh=None):
        self.mesh = mesh


class BinOp(Expr):
    def __init__(self, op, a, b):
        self.op, self.a, self.b = op, a, b


class DotOp(Expr):
    def __init__(self, a, b):
        self.a, self.b = a, b


class InnerOp(Expr):
    def __init__(self, a, b):
        self.a, self.b = a, b


class UnaryOp(Expr):
    def __init__(self, fn, a):
        self.fn, self.a = fn, a


def _wrap(o):
    if isinstance(o, Expr):
        return o
    if isinstance(o, Function):
        return FunctionLeaf(o)
    if isinstance(o, Constant):
        v = np.asarray(o.value)
        return ScalarLeaf(float(v)) if v.ndim == 0 else TensorLeaf(v)
    if isinstance(o, numbers.Number):
        return ScalarLeaf(float(o))
    if isinstance(o, (tuple, list, np.ndarray)):
        return TensorLeaf(o)
    raise TypeError(f"cannot use {type(o)} in a functional expression")


# -- public constructors (UFL-name parity) ------------------------------------


def grad(f):
    if isinstance(f, Function):
        return GradLeaf(f)
    raise TypeError("grad() supports discrete Functions in functionals")


def nabla_grad(f):
    return grad(f)


def dot(a, b):
    return DotOp(_wrap(a), _wrap(b))


def inner(a, b):
    return InnerOp(_wrap(a), _wrap(b))


def sqrt(a):
    return UnaryOp(np.sqrt, _wrap(a))


def abs_(a):
    return UnaryOp(np.abs, _wrap(a))


def FacetNormal(mesh):
    return NormalLeaf(mesh)


def SpatialCoordinate(mesh):
    return CoordLeaf(mesh)


class Measure:
    """``Measure('ds', subdomain_data=facet_markers)``; call with an id."""

    def __init__(self, kind, domain=None, subdomain_data=None, subdomain_id=None):
        assert kind in ("dx", "ds")
        self.kind = kind
        self.subdomain_data = subdomain_data
        self.subdomain_id = subdomain_id
        self.domain = domain

    def __call__(self, subdomain_id=None, **kw):
        return Measure(
            self.kind,
            domain=self.domain,
            subdomain_data=self.subdomain_data,
            subdomain_id=subdomain_id,
        )

    def __rmul__(self, expr):
        return IntegralForm(_wrap(expr), self)


class IntegralForm:
    def __init__(self, expr, measure):
        self.terms = [(expr, measure)]

    def __add__(self, o):
        out = IntegralForm.__new__(IntegralForm)
        out.terms = self.terms + o.terms
        return out

    def __sub__(self, o):
        neg = IntegralForm.__new__(IntegralForm)
        neg.terms = [(BinOp("*", ScalarLeaf(-1.0), e), m) for e, m in o.terms]
        out = IntegralForm.__new__(IntegralForm)
        out.terms = self.terms + neg.terms
        return out


# -- evaluation ----------------------------------------------------------------


def _find_mesh(expr):
    if isinstance(expr, (FunctionLeaf, GradLeaf)):
        return expr.fn.space.mesh
    if isinstance(expr, (NormalLeaf, CoordLeaf)) and expr.mesh is not None:
        return expr.mesh
    for child in ("a", "b"):
        if hasattr(expr, child):
            m = _find_mesh(getattr(expr, child))
            if m is not None:
                return m
    return None


class _EvalCtx:
    """Evaluation context for one batch of entities."""

    def __init__(self, mesh, kind, entity_ids, qdeg):
        self.mesh = mesh
        self.kind = kind
        self.qdeg = qdeg
        tdim = mesh.tdim
        if kind == "cell":
            qp, qw = elements.quadrature(tdim, qdeg)
            Xe = mesh.coords[mesh.cells_array[entity_ids]]
            lam = np.concatenate([1 - qp.sum(1, keepdims=True), qp], axis=1)
            self.qpx = np.einsum("qv,cvg->cqg", lam, Xe)
            J = np.swapaxes(Xe[:, 1:, :] - Xe[:, :1, :], 1, 2)
            self.detJ = np.abs(np.linalg.det(J))
            self.Jinv = np.linalg.inv(J)
            self.qw = qw
            self.cells = entity_ids
            self.ref_pts = qp
            self.normal = None
        else:  # facet
            info = mesh._compute_facets()
            cells_of = info["facet_cells"][entity_ids, 0]
            local = info["facet_local"][entity_ids, 0]
            fv = info["facet_vertices"][entity_ids]
            X = mesh.coords[fv]
            cell_pts, fpts, fw = elements.facet_quadrature_in_cell(tdim, qdeg)
            lam_f = np.concatenate(
                [1 - fpts.sum(1, keepdims=True), fpts], axis=1
            )
            self.qpx = np.einsum("qv,fvg->fqg", lam_f, X)
            if tdim == 2:
                e = X[:, 1] - X[:, 0]
                area = np.linalg.norm(e, axis=1)
                refvol = 1.0
                n = np.stack([e[:, 1], -e[:, 0]], axis=1)
            else:
                c = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
                area = 0.5 * np.linalg.norm(c, axis=1)
                refvol = 0.5
                n = c
            n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
            mid = mesh.coords[mesh.cells_array[cells_of]].mean(axis=1)
            sign = np.sign(np.einsum("fg,fg->f", X.mean(axis=1) - mid, n))
            sign[sign == 0] = 1
            self.normal = n * sign[:, None]
            self.detJ = area / refvol
            self.qw = fw
            self.cells = cells_of
            # reference coords of facet qp inside the owning cell
            self.ref_pts_per_entity = cell_pts[local]  # (nf, nq, tdim)
            Xc = mesh.coords[mesh.cells_array[cells_of]]
            Jc = np.swapaxes(Xc[:, 1:, :] - Xc[:, :1, :], 1, 2)
            self.Jinv = np.linalg.inv(Jc)

    def fn_values(self, fn):
        space = fn.space
        scalar = (
            space.scalar_space
            if isinstance(space, VectorFunctionSpace)
            else space
        )
        cd = scalar.cell_dofs[self.cells]
        if self.kind == "cell":
            phi, _ = elements.tabulate(self.mesh.tdim, scalar.degree, self.ref_pts)
            phi_e = np.broadcast_to(
                phi, (len(self.cells),) + phi.shape
            )  # (ne, nq, k)
        else:
            nf, nq, tdim = self.ref_pts_per_entity.shape
            phi_e = np.stack(
                [
                    elements.tabulate(
                        self.mesh.tdim, scalar.degree, self.ref_pts_per_entity[i]
                    )[0]
                    for i in range(nf)
                ]
            )
        if isinstance(space, VectorFunctionSpace):
            vals = fn.values.reshape(-1, space.vdim)[cd]  # (ne,k,v)
            return np.einsum("eqk,ekv->eqv", phi_e, vals)
        return np.einsum("eqk,ek->eq", phi_e, fn.values[cd])

    def fn_grads(self, fn):
        space = fn.space
        scalar = (
            space.scalar_space
            if isinstance(space, VectorFunctionSpace)
            else space
        )
        cd = scalar.cell_dofs[self.cells]
        if self.kind == "cell":
            _, dphi = elements.tabulate(self.mesh.tdim, scalar.degree, self.ref_pts)
            dphi_e = np.broadcast_to(
                dphi, (len(self.cells),) + dphi.shape
            )
        else:
            dphi_e = np.stack(
                [
                    elements.tabulate(
                        self.mesh.tdim, scalar.degree, self.ref_pts_per_entity[i]
                    )[1]
                    for i in range(len(self.cells))
                ]
            )
        dphig = np.einsum("eqkt,etg->eqkg", dphi_e, self.Jinv)
        if isinstance(space, VectorFunctionSpace):
            vals = fn.values.reshape(-1, space.vdim)[cd]
            return np.einsum("eqkg,ekv->eqvg", dphig, vals)
        return np.einsum("eqkg,ek->eqg", dphig, fn.values[cd])


def _eval(expr, ctx):
    """Evaluate to an array broadcastable over (ne, nq, ...)."""
    if isinstance(expr, ScalarLeaf):
        return expr.value
    if isinstance(expr, TensorLeaf):
        return expr.value
    if isinstance(expr, FunctionLeaf):
        return ctx.fn_values(expr.fn)
    if isinstance(expr, GradLeaf):
        return ctx.fn_grads(expr.fn)
    if isinstance(expr, NormalLeaf):
        if ctx.normal is None:
            raise ValueError("FacetNormal used in a cell integral")
        return ctx.normal[:, None, :]  # (ne,1,g)
    if isinstance(expr, CoordLeaf):
        return ctx.qpx
    if isinstance(expr, BinOp):
        a, b = _eval(expr.a, ctx), _eval(expr.b, ctx)
        return {
            "+": np.add, "-": np.subtract, "*": np.multiply,
            "/": np.divide, "**": np.power,
        }[expr.op](a, b)
    if isinstance(expr, (DotOp, InnerOp)):
        a, b = _eval(expr.a, ctx), _eval(expr.b, ctx)
        a, b = np.broadcast_arrays(np.asarray(a, dtype=np.float64),
                                   np.asarray(b, dtype=np.float64))
        if isinstance(expr, InnerOp) and a.ndim >= 4:
            return np.einsum("...ab,...ab->...", a, b)
        return np.einsum("...g,...g->...", a, b)
    if isinstance(expr, UnaryOp):
        return expr.fn(_eval(expr.a, ctx))
    raise TypeError(f"cannot evaluate {type(expr)}")


def assemble(form, quad_degree=None):
    """Evaluate an IntegralForm (or a bare Expr over all cells) to a float."""
    if isinstance(form, Expr):
        form = IntegralForm(form, Measure("dx"))
    total = 0.0
    for expr, measure in form.terms:
        mesh = (measure.domain or _find_mesh(expr))
        if mesh is None:
            raise ValueError("cannot infer mesh for functional assembly")
        qdeg = quad_degree or 4
        if measure.kind == "dx":
            if measure.subdomain_id is None or measure.subdomain_data is None:
                ids = np.arange(mesh.num_cells())
            else:
                ids = measure.subdomain_data.where_equal(measure.subdomain_id)
            ctx = _EvalCtx(mesh, "cell", np.asarray(ids), qdeg)
        else:
            if measure.subdomain_id is None or measure.subdomain_data is None:
                ids = mesh.exterior_facets()
            else:
                ids = measure.subdomain_data.where_equal(measure.subdomain_id)
                ext = mesh.exterior_facet_mask()
                ids = ids[ext[ids]]
            if len(ids) == 0:
                continue
            ctx = _EvalCtx(mesh, "facet", np.asarray(ids), qdeg)
        vals = _eval(expr, ctx)
        vals = np.broadcast_to(
            np.asarray(vals, dtype=np.float64), (len(ctx.cells), len(ctx.qw))
        )
        total += float(np.einsum("eq,q,e->", vals, ctx.qw, ctx.detJ))
    return total
