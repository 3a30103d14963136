"""Matplotlib plotting of meshes, mesh functions and FE functions.

Port of ``fenicssolver_tpu/utils/plotting.py`` (the same code; it replaces
dolfin ``plot``).  matplotlib is imported inside ``plot()``, so the package
imports without it.  Headless environments simply render to the current
figure; ``plt.show`` is gated by the caller.
"""

from __future__ import annotations

import numpy as np


def plot(obj, title=None, mode=None, wireframe=False, **kw):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    from ..core.function import Function
    from ..core.mesh import Mesh, MeshFunction
    from ..core.spaces import VectorFunctionSpace

    fig = plt.gcf()
    ax = plt.gca()
    if title:
        ax.set_title(title)

    if isinstance(obj, Mesh):
        return _plot_mesh(ax, obj)
    if isinstance(obj, MeshFunction):
        return _plot_meshfunction(ax, obj)
    if isinstance(obj, Function):
        mesh = obj.space.mesh
        if mesh.tdim != 2:
            # 3D: plot a histogram of values as a cheap headless fallback
            ax.hist(np.asarray(obj.values).ravel(), bins=50)
            ax.set_xlabel(obj.name())
            return ax
        tri = _triangulation(mesh)
        if isinstance(obj.space, VectorFunctionSpace):
            vals = obj.values.reshape(-1, obj.space.vdim)
            nodal = vals[: mesh.num_vertices()]
            mag = np.linalg.norm(nodal, axis=1)
            tc = ax.tripcolor(tri, mag, shading="gouraud")
            step = max(1, mesh.num_vertices() // 800)
            ax.quiver(
                mesh.coords[::step, 0],
                mesh.coords[::step, 1],
                nodal[::step, 0],
                nodal[::step, 1],
            )
        else:
            nodal = np.asarray(obj.values)[: mesh.num_vertices()]
            tc = ax.tripcolor(tri, nodal, shading="gouraud")
        plt.colorbar(tc, ax=ax)
        return ax
    raise TypeError(f"cannot plot {type(obj)}")


def _triangulation(mesh):
    from matplotlib.tri import Triangulation

    return Triangulation(mesh.coords[:, 0], mesh.coords[:, 1], mesh.cells_array)


def _plot_mesh(ax, mesh):
    if mesh.tdim == 2:
        ax.triplot(_triangulation(mesh), lw=0.3)
    return ax


def _plot_meshfunction(ax, mf):
    mesh = mf.mesh
    if mesh.tdim == 2 and mf.dim == 2:
        tc = ax.tripcolor(_triangulation(mesh), facecolors=mf.values.astype(float))
        import matplotlib.pyplot as plt

        plt.colorbar(tc, ax=ax)
    elif mesh.tdim == 2 and mf.dim == 1:
        fv = mesh.facets()
        marked = mf.values != 0
        for f in np.nonzero(marked)[0]:
            seg = mesh.coords[fv[f]]
            ax.plot(seg[:, 0], seg[:, 1], lw=1.5)
    return ax


def interactive():
    import matplotlib.pyplot as plt

    plt.show()
