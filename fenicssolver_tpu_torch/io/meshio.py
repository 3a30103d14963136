"""Mesh input: legacy dolfin XML meshes and mesh functions.

Port of ``fenicssolver_tpu/io/meshio.py:21-139`` (host numpy, unchanged):
``data/mesh.xml`` and its ``*_facet_region.xml`` / ``*_physical_region.xml``
sidecars load bit-exactly, with dolfin's facet numbering (see
``core.mesh.Mesh._compute_facets``).  The HDF5/XDMF readers and the VTU/PVD
writers raise ``NotImplementedError``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


def _strip_ns(tag):
    return tag.rsplit("}", 1)[-1]


def read_mesh(filename):
    """Read a dolfin XML mesh file (.xml).  HDF5 and XDMF raise."""
    from ..core.mesh import Mesh

    if filename.endswith(".xml"):
        coords, cells = read_dolfin_xml(filename)
        return Mesh(coords, cells)
    if filename.endswith((".h5", ".hdf5", ".xdmf")):
        raise NotImplementedError(
            f"reading {filename!r}: the HDF5/XDMF readers are not ported to "
            "fenicssolver_tpu_torch yet; they come with the rest of io/meshio.py"
        )
    raise ValueError(f"unsupported mesh format: {filename}")


def read_dolfin_xml(filename):
    """Parse legacy dolfin XML mesh -> (coords, cells)."""
    root = ET.parse(filename).getroot()
    mesh_el = None
    for el in root.iter():
        if _strip_ns(el.tag) == "mesh":
            mesh_el = el
            break
    if mesh_el is None:
        raise ValueError(f"no <mesh> element in {filename}")
    celltype = mesh_el.attrib["celltype"]
    dim = int(mesh_el.attrib["dim"])
    verts_el = cells_el = None
    for el in mesh_el:
        t = _strip_ns(el.tag)
        if t == "vertices":
            verts_el = el
        elif t == "cells":
            cells_el = el
    nv = int(verts_el.attrib["size"])
    coords = np.zeros((nv, dim))
    axes = ["x", "y", "z"][:dim]
    for v in verts_el:
        i = int(v.attrib["index"])
        for k, ax in enumerate(axes):
            coords[i, k] = float(v.attrib[ax])
    nc = int(cells_el.attrib["size"])
    nvc = {"interval": 2, "triangle": 3, "tetrahedron": 4}[celltype]
    cells = np.zeros((nc, nvc), dtype=np.int32)
    keys = [f"v{k}" for k in range(nvc)]
    for c in cells_el:
        i = int(c.attrib["index"])
        for k, key in enumerate(keys):
            cells[i, k] = int(c.attrib[key])
    return coords, cells


def read_mesh_function_xml(filename, dtype=np.int64, mesh=None):
    """Parse dolfin XML MeshFunction -> (entity_dim, values array).

    Also reads new-style ``<mesh_value_collection>`` files (entries keyed
    by (cell_index, local_entity) instead of global entity index), which
    dolfin emits since 2018; these need the ``mesh`` to resolve local
    entities to global ones."""
    root = ET.parse(filename).getroot()
    mf = None
    for el in root.iter():
        if _strip_ns(el.tag) in ("mesh_function", "meshfunction"):
            mf = el
            break
    if mf is None:
        for el in root.iter():
            if _strip_ns(el.tag) == "mesh_value_collection":
                return _read_mesh_value_collection(el, dtype, mesh, filename)
        raise ValueError(f"no <mesh_function> in {filename}")
    dim = int(mf.attrib["dim"])
    size = int(mf.attrib["size"])
    values = np.zeros(size, dtype=dtype)
    for e in mf:
        values[int(e.attrib["index"])] = dtype(e.attrib["value"])
    return dim, values


def _read_mesh_value_collection(mvc, dtype, mesh, filename):
    if mesh is None:
        raise ValueError(
            f"{filename} is a mesh_value_collection; a mesh is required to "
            "resolve (cell, local_entity) keys — construct via "
            "MeshFunction(type, mesh, filename)"
        )
    dim = int(mvc.attrib["dim"])
    cells = np.array([int(e.attrib["cell_index"]) for e in mvc], dtype=np.int64)
    local = np.array([int(e.attrib["local_entity"]) for e in mvc], dtype=np.int64)
    vals = np.array([dtype(e.attrib["value"]) for e in mvc], dtype=dtype)
    tdim = mesh.tdim
    if dim == tdim:
        values = np.zeros(mesh.num_cells(), dtype=dtype)
        values[cells] = vals
    elif dim == tdim - 1:
        # facet entries: local facet i is opposite vertex i (dolfin rule,
        # matching core/mesh.py's facet tables)
        info = mesh._compute_facets()
        fc, fl = info["facet_cells"], info["facet_local"]
        nlf = tdim + 1
        nf = fc.shape[0]
        lut = {}
        for f in range(nf):
            lut[fc[f, 0] * nlf + fl[f, 0]] = f
            if fc[f, 1] >= 0:
                lut[fc[f, 1] * nlf + fl[f, 1]] = f
        values = np.zeros(nf, dtype=dtype)
        for c, l, v in zip(cells, local, vals):
            values[lut[int(c) * nlf + int(l)]] = v
    elif dim == 0:
        values = np.zeros(mesh.num_vertices(), dtype=dtype)
        values[mesh.cells_array[cells, local]] = vals
    else:
        raise NotImplementedError(
            f"mesh_value_collection of dim {dim} on a {tdim}D mesh"
        )
    return dim, values
