"""Binary (HDF5) field-data collection.

Stands in for the reference's Conduit/ADIOS2 binary DataCollections
(src/mechanics_driver.cpp:637-643,769-817): one HDF5 file per run holding
the mesh (blueprint-style coordsets/topology) plus one group per saved
cycle with all element/nodal fields.  Readable from Python with h5py and
convertible to Conduit Blueprint trees directly (matching group layout:
coordsets/coords/values/{x,y,z}, topologies/mesh/elements/connectivity,
fields/<name>/values).
"""

from __future__ import annotations

import os

import numpy as np


def write_hdf5_step(path, ti, t, coords, conn, cell_fields, point_fields):
    """Append one cycle to the run's HDF5 data collection."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "a") as f:
        if "topologies" not in f:
            g = f.create_group("topologies/mesh")
            g.attrs["type"] = "unstructured"
            g.attrs["shape"] = "hex"
            g.create_dataset("elements/connectivity",
                             data=np.asarray(conn, dtype=np.int64))
        cyc = f.create_group(f"cycles/{ti:06d}")
        cyc.attrs["time"] = float(t)
        cyc.attrs["cycle"] = int(ti)
        cs = cyc.create_group("coordsets/coords/values")
        xyz = np.asarray(coords, dtype=np.float64)
        for k, name in enumerate("xyz"):
            cs.create_dataset(name, data=xyz[:, k])
        fg = cyc.create_group("fields")
        for name, data in (cell_fields or {}).items():
            d = fg.create_group(name)
            d.attrs["association"] = "element"
            d.create_dataset("values", data=np.asarray(data,
                                                       dtype=np.float64))
        for name, data in (point_fields or {}).items():
            d = fg.create_group(name)
            d.attrs["association"] = "vertex"
            d.create_dataset("values", data=np.asarray(data,
                                                       dtype=np.float64))
