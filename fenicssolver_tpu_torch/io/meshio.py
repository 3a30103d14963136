"""Mesh I/O: legacy dolfin XML, HDF5 and XDMF meshes and mesh functions,
VTU/PVD output.

Port of ``fenicssolver_tpu/io/meshio.py`` (host numpy, unchanged):
``data/mesh.xml`` and its ``*_facet_region.xml`` / ``*_physical_region.xml``
sidecars load bit-exactly, with dolfin's facet numbering (see
``core.mesh.Mesh._compute_facets``); the dolfin XML writers; the dolfin
HDF5 layout (``read_hdf5`` / ``write_hdf5``) and a minimal XDMF reader
(inline XML or HDF5-backed data items); and the VTU writer and ``PVDFile``
time series behind ``SolverBase.save``.  ``h5py`` is imported inside the
functions that need it, so an inline-XML XDMF file reads without it.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np


def _strip_ns(tag):
    return tag.rsplit("}", 1)[-1]


def read_mesh(filename):
    """Read a mesh file by extension (.xml, .h5/.hdf5, .xdmf)."""
    from ..core.mesh import Mesh

    if filename.endswith(".xml"):
        coords, cells = read_dolfin_xml(filename)
        return Mesh(coords, cells)
    if filename.endswith((".h5", ".hdf5")):
        coords, cells, _, _ = read_hdf5(filename)
        return Mesh(coords, cells)
    if filename.endswith(".xdmf"):
        coords, cells = read_xdmf(filename)
        return Mesh(coords, cells)
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


def write_dolfin_xml(filename, mesh):
    """Write legacy dolfin XML (so cases remain interoperable with dolfin)."""
    celltype = {1: "interval", 2: "triangle", 3: "tetrahedron"}[mesh.tdim]
    axes = ["x", "y", "z"][: mesh.gdim]
    with open(filename, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n\n')
        f.write('<dolfin xmlns:dolfin="http://www.fenicsproject.org">\n')
        f.write(f'  <mesh celltype="{celltype}" dim="{mesh.gdim}">\n')
        f.write(f'    <vertices size="{mesh.num_vertices()}">\n')
        for i, xyz in enumerate(mesh.coords):
            attrs = " ".join(f'{a}="{v:.16e}"' for a, v in zip(axes, xyz))
            f.write(f'      <vertex index="{i}" {attrs}/>\n')
        f.write("    </vertices>\n")
        f.write(f'    <cells size="{mesh.num_cells()}">\n')
        for i, c in enumerate(mesh.cells_array):
            attrs = " ".join(f'v{k}="{v}"' for k, v in enumerate(c))
            f.write(f'      <{celltype} index="{i}" {attrs}/>\n')
        f.write("    </cells>\n  </mesh>\n</dolfin>\n")


def write_mesh_function_xml(filename, mesh_function):
    with open(filename, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n')
        f.write('<dolfin xmlns:dolfin="http://fenicsproject.org">\n')
        f.write(
            f'  <mesh_function type="uint" dim="{mesh_function.dim}" '
            f'size="{mesh_function.size()}">\n'
        )
        for i, v in enumerate(mesh_function.values):
            f.write(f'    <entity index="{i}" value="{int(v)}"/>\n')
        f.write("  </mesh_function>\n</dolfin>\n")



def read_hdf5(filename):
    """The dolfin HDF5 layout: /mesh (topology, coordinates), /subdomains,
    /boundaries -> (coords, cells, subdomain values or None, boundary
    values or None)."""
    import h5py

    with h5py.File(filename, "r") as f:
        topo = np.asarray(f["/mesh/topology"])
        coords = np.asarray(f["/mesh/coordinates"])
        sub = np.asarray(f["/subdomains/values"]) if "/subdomains" in f else None
        bnd = np.asarray(f["/boundaries/values"]) if "/boundaries" in f else None
    return coords, topo.astype(np.int32), sub, bnd


def write_hdf5(filename, mesh, subdomains=None, boundaries=None):
    import h5py

    with h5py.File(filename, "w") as f:
        f.create_dataset("/mesh/topology", data=mesh.cells_array)
        f.create_dataset("/mesh/coordinates", data=mesh.coords)
        if subdomains is not None:
            f.create_dataset("/subdomains/values", data=np.asarray(subdomains))
        if boundaries is not None:
            f.create_dataset("/boundaries/values", data=np.asarray(boundaries))


def read_xdmf(filename):
    """A minimal XDMF reader: the first Topology and Geometry, each an
    inline (``Format="XML"``) or HDF5-backed (``Format="HDF"``) data item
    -> (coords, cells)."""
    root = ET.parse(filename).getroot()
    topo_el = geom_el = None
    for el in root.iter():
        t = _strip_ns(el.tag)
        if t == "Topology" and topo_el is None:
            topo_el = el
        elif t == "Geometry" and geom_el is None:
            geom_el = el
    if topo_el is None or geom_el is None:
        raise ValueError("XDMF missing Topology/Geometry")

    def load_data_item(el):
        di = next(iter(el))
        fmt = di.attrib.get("Format", "XML")
        dims = [int(d) for d in di.attrib["Dimensions"].split()]
        if fmt == "XML":
            return np.array(di.text.split(), dtype=np.float64).reshape(dims)
        if fmt == "HDF":
            path, dset = di.text.strip().split(":")
            import h5py

            base = os.path.dirname(os.path.abspath(filename))
            with h5py.File(os.path.join(base, path), "r") as f:
                return np.asarray(f[dset])
        raise ValueError(f"unsupported XDMF data format {fmt}")

    cells = load_data_item(topo_el).astype(np.int32)
    coords = load_data_item(geom_el).astype(np.float64)
    if geom_el.attrib.get("GeometryType", "XYZ") == "XY":
        coords = coords[:, :2]
    return coords, cells


# ---------------------------------------------------------------------------
# Output: VTU (XML unstructured grid) + PVD collection, replacing dolfin pvd
# (reference ``SolverBase.py:570-589``).
# ---------------------------------------------------------------------------

_VTK_CELL = {1: 3, 2: 5, 3: 10}  # line, triangle, tetra


def write_vtu(filename, mesh, point_data=None, cell_data=None):
    """ASCII VTU of the mesh's vertices and cells, with point and cell
    arrays (values printed to 12 significant digits)."""
    nv, nc = mesh.num_vertices(), mesh.num_cells()
    coords3 = np.zeros((nv, 3))
    coords3[:, : mesh.gdim] = mesh.coords
    conn = mesh.cells_array
    with open(filename, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="UnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n<UnstructuredGrid>\n'
        )
        f.write(f'<Piece NumberOfPoints="{nv}" NumberOfCells="{nc}">\n')
        f.write("<Points>\n")
        f.write(
            '<DataArray type="Float64" NumberOfComponents="3" format="ascii">\n'
        )
        np.savetxt(f, coords3, fmt="%.12g")
        f.write("</DataArray>\n</Points>\n<Cells>\n")
        f.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
        np.savetxt(f, conn, fmt="%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="Int32" Name="offsets" format="ascii">\n')
        np.savetxt(f, (np.arange(1, nc + 1) * conn.shape[1])[:, None], fmt="%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="UInt8" Name="types" format="ascii">\n')
        np.savetxt(
            f, np.full((nc, 1), _VTK_CELL[mesh.tdim], dtype=np.uint8), fmt="%d"
        )
        f.write("</DataArray>\n</Cells>\n")
        f.write("<PointData>\n")
        for name, arr in (point_data or {}).items():
            arr = np.asarray(arr)
            if arr.ndim == 1:
                ncomp, flat = 1, arr[:, None]
            else:
                ncomp = arr.shape[1]
                if ncomp == 2:  # pad 2D vectors for paraview
                    flat = np.concatenate([arr, np.zeros((arr.shape[0], 1))], axis=1)
                    ncomp = 3
                else:
                    flat = arr
            f.write(
                f'<DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="ascii">\n'
            )
            np.savetxt(f, flat, fmt="%.12g")
            f.write("</DataArray>\n")
        f.write("</PointData>\n<CellData>\n")
        for name, arr in (cell_data or {}).items():
            arr = np.asarray(arr)
            f.write(
                f'<DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="1" format="ascii">\n'
            )
            np.savetxt(f, arr.reshape(-1, 1), fmt="%.12g")
            f.write("</DataArray>\n")
        f.write("</CellData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")


class PVDFile:
    """dolfin ``File('result.pvd') << (fn, t)`` parity: a VTU time series.

    Each write adds ``<base>NNNNNN.vtu`` (the function's vertex values) and
    rewrites the collection file."""

    def __init__(self, filename):
        assert filename.endswith(".pvd")
        self.filename = filename
        self.entries = []
        self._counter = 0

    def write(self, fn, t=0.0):
        from ..core.function import Function

        if not isinstance(fn, Function):
            raise TypeError(f"cannot write {type(fn)}")
        vtu = f"{self.filename[:-4]}{self._counter:06d}.vtu"
        space = fn.space
        nodal = fn.nodal_values()[: space.mesh.num_vertices()]
        write_vtu(vtu, space.mesh, point_data={fn.name(): nodal})
        self.entries.append((t, os.path.basename(vtu)))
        self._counter += 1
        self._flush()

    def _flush(self):
        with open(self.filename, "w") as f:
            f.write('<?xml version="1.0"?>\n<VTKFile type="Collection">\n')
            f.write("<Collection>\n")
            for t, name in self.entries:
                f.write(f'<DataSet timestep="{t}" part="0" file="{name}"/>\n')
            f.write("</Collection>\n</VTKFile>\n")

    def __lshift__(self, item):
        if isinstance(item, tuple):
            self.write(item[0], item[1])
        else:
            self.write(item)
        return self
