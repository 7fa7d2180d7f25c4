"""Binary persistence for scene objects: the port's own copy of
``metalens_tpu/serialization.py``, with the same npz layout, so a database
written by either package loads in the other.

One ``.npz`` holds the geometry arrays and the characterize databases as
packed structured arrays.  Interpolators are not stored; they are rebuilt
on demand.

API::

    save(obj, "collection.npz")     # Grating | GratingCollection | HexGridSet
    obj = load("collection.npz")
"""

from __future__ import annotations

import os

import numpy as np

from .grating import Grating, GratingCollection
from .hexgrid import HexGridSet

_DATA_DTYPE = np.dtype([
    ("wavelength_in_nm", np.float64),
    ("x_or_y", "S1"),
    ("ux", np.float64), ("uy", np.float64),
    ("ox", np.int32), ("oy", np.int32),
    ("ampfy", np.complex128), ("ampfx", np.complex128),
    ("ampry", np.complex128), ("amprx", np.complex128),
])


def _pack_data(data):
    out = np.zeros(len(data), dtype=_DATA_DTYPE)
    for i, e in enumerate(data):
        out[i] = (e["wavelength_in_nm"], e["x_or_y"].encode(), e["ux"],
                  e["uy"], e["ox"], e["oy"], e["ampfy"], e["ampfx"],
                  e["ampry"], e["amprx"])
    return out


def _unpack_data(arr):
    return [{"wavelength_in_nm": float(r["wavelength_in_nm"]),
             "x_or_y": r["x_or_y"].decode(),
             "ux": float(r["ux"]), "uy": float(r["uy"]),
             "ox": int(r["ox"]), "oy": int(r["oy"]),
             "ampfy": complex(r["ampfy"]), "ampfx": complex(r["ampfx"]),
             "ampry": complex(r["ampry"]), "amprx": complex(r["amprx"])}
            for r in arr]


def _grating_fields(g, prefix, store):
    store[prefix + "meta"] = np.array([g.lateral_period, g.grating_period,
                                       g.cyl_height, g.n_glass, g.n_tio2])
    store[prefix + "xyrra"] = np.asarray(g.xyrra_list)
    if hasattr(g, "data"):
        store[prefix + "data"] = _pack_data(g.data)


def _grating_from(store, prefix):
    meta = store[prefix + "meta"]
    g = Grating(lateral_period=float(meta[0]), grating_period=float(meta[1]),
                cyl_height=float(meta[2]), n_glass=float(meta[3]),
                n_tio2=float(meta[4]))
    # integer-valued indices were stored as floats; restore exact ints for
    # the 0-sentinel comparison
    if g.n_glass == int(g.n_glass):
        g.n_glass = int(g.n_glass)
    if g.n_tio2 == int(g.n_tio2):
        g.n_tio2 = int(g.n_tio2)
    g.xyrra_list = np.array(store[prefix + "xyrra"])
    key = prefix + "data"
    if key in store:
        g.data = _unpack_data(store[key])
    return g


def save(obj, path):
    store = {}
    if isinstance(obj, Grating):
        store["kind"] = np.array("grating")
        _grating_fields(obj, "g0_", store)
    elif isinstance(obj, GratingCollection):
        store["kind"] = np.array("collection")
        store["meta"] = np.array([obj.target_wavelength, obj.lateral_period])
        store["lens_type"] = np.array(obj.lens_type)
        store["n_members"] = np.array(len(obj.grating_list))
        for i, g in enumerate(obj.grating_list):
            _grating_fields(g, f"g{i}_", store)
    elif isinstance(obj, HexGridSet):
        store["kind"] = np.array("hexgridset")
        store["meta"] = np.array([obj.sep, obj.cyl_height, obj.n_glass,
                                  obj.n_tio2])
        store["n_members"] = np.array(len(obj.grating_list))
        if hasattr(obj, "x_amp_list"):
            store["x_amp_list"] = np.asarray(obj.x_amp_list)
        for i, g in enumerate(obj.grating_list):
            _grating_fields(g, f"g{i}_", store)
    else:
        raise TypeError(type(obj))
    # np.savez appends '.npz' to a path without it: return the file
    # actually written
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, **store)
    return path


def load(path):
    store = np.load(path, allow_pickle=False)
    kind = str(store["kind"])
    if kind == "grating":
        return _grating_from(store, "g0_")
    if kind == "collection":
        meta = store["meta"]
        gs = [_grating_from(store, f"g{i}_")
              for i in range(int(store["n_members"]))]
        return GratingCollection(target_wavelength=float(meta[0]),
                                 lateral_period=float(meta[1]),
                                 lens_type=str(store["lens_type"]),
                                 grating_list=gs)
    if kind == "hexgridset":
        meta = store["meta"]
        gs = [_grating_from(store, f"g{i}_")
              for i in range(int(store["n_members"]))]
        x_amp = (np.array(store["x_amp_list"])
                 if "x_amp_list" in store else None)
        hgs = HexGridSet(sep=float(meta[0]), cyl_height=float(meta[1]),
                         n_glass=float(meta[2]) if meta[2] != int(meta[2])
                         else int(meta[2]),
                         n_tio2=float(meta[3]) if meta[3] != int(meta[3])
                         else int(meta[3]),
                         grating_list=gs, x_amp_list=x_amp)
        return hgs
    raise ValueError(f"unknown kind {kind!r}")
