"""ParaView (VTU) field output.

TPU-native replacement for the reference's VisIt/ParaView/Conduit/ADIOS2
DataCollections (src/mechanics_driver.cpp:610-817).  Fields are written as
cell data (the reference also projects everything to element-constant L2
fields, system_driver.cpp:560-871) on the deformed hex mesh.
"""

from __future__ import annotations

import os

import numpy as np


def _cell_corners(conn, order):
    """Corner nodes of each element in VTK hexahedron ordering."""
    p = order
    n = p + 1

    def lex(i, j, k):
        return i + n * (j + n * k)

    corners = [lex(0, 0, 0), lex(p, 0, 0), lex(p, p, 0), lex(0, p, 0),
               lex(0, 0, p), lex(p, 0, p), lex(p, p, p), lex(0, p, p)]
    return conn[:, corners]


def write_vtu(path, coords, conn, order, cell_fields=None,
              point_fields=None):
    """Write an unstructured hex mesh with fields to a .vtu file."""
    cell_fields = cell_fields or {}
    point_fields = point_fields or {}
    cells = _cell_corners(np.asarray(conn), order)
    npts = coords.shape[0]
    ncells = cells.shape[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def arr_txt(a):
        a = np.asarray(a)
        if a.ndim == 1:
            a = a[:, None]
        return "\n".join(" ".join(f"{v:.10g}" for v in row) for row in a)

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncells}">\n')
        f.write('<Points>\n<DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        f.write(arr_txt(coords))
        f.write('\n</DataArray>\n</Points>\n<Cells>\n')
        f.write('<DataArray type="Int64" Name="connectivity" format="ascii">'
                "\n")
        f.write("\n".join(" ".join(map(str, row)) for row in cells))
        f.write('\n</DataArray>\n<DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        f.write(" ".join(str(8 * (i + 1)) for i in range(ncells)))
        f.write('\n</DataArray>\n<DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        f.write(" ".join(["12"] * ncells))
        f.write('\n</DataArray>\n</Cells>\n')
        f.write('<CellData>\n')
        for name, data in cell_fields.items():
            data = np.asarray(data)
            ncomp = 1 if data.ndim == 1 else data.shape[1]
            f.write(f'<DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            f.write(arr_txt(data))
            f.write("\n</DataArray>\n")
        f.write('</CellData>\n<PointData>\n')
        for name, data in point_fields.items():
            data = np.asarray(data)
            ncomp = 1 if data.ndim == 1 else data.shape[1]
            f.write(f'<DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            f.write(arr_txt(data))
            f.write("\n</DataArray>\n")
        f.write('</PointData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')


def write_pvd(path, entries):
    """Write a ParaView collection file; entries = [(time, vtu_path), ...]"""
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" '
                'version="0.1">\n<Collection>\n')
        for t, vtu in entries:
            f.write(f'<DataSet timestep="{t}" group="" part="0" '
                    f'file="{vtu}"/>\n')
        f.write('</Collection>\n</VTKFile>\n')
