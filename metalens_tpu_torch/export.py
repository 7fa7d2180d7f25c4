"""Fabrication export: DXF, SVG and GDSII files of full pillar layouts.

Counterpart of ``metalens_tpu/export.py``, with the same writers and the
same file bytes: a DXF R12 subset, plain SVG, and a binary GDSII stream
(circles as CIRCLE entities, ellipses as closed polylines of 16 segments in
DXF; every pillar a closed BOUNDARY polygon in GDSII; coordinates in
micrometres).  The native C++ writer of ``native/fastexport.cpp`` streams
millions of pillars per second; the Python writers are its plain version.

The native library is compiled with ``g++ -O3 -shared -fPIC`` into
``build/fastexport/`` at the root of the checkout (rebuilt when the source
is newer) and loaded with :mod:`ctypes`.  ``use_native=True`` raises when
it cannot be built or loaded; ``use_native=False`` selects the Python
writers.  Everything here is numpy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .units import um, pi

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(_ROOT, "native", "fastexport.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "fastexport")

_libs: dict = {}
_lock = threading.Lock()
_DOUBLES = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "write_dxf_r12": [ctypes.c_char_p, _DOUBLES, ctypes.c_long, ctypes.c_int],
    "write_svg": [ctypes.c_char_p, _DOUBLES, ctypes.c_long],
    "write_gds": [ctypes.c_char_p, _DOUBLES, ctypes.c_long, ctypes.c_int,
                  ctypes.c_int],
}


def _build(src: str, out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders agree


def _native_lib():
    """The native exporter, built from ``SRC_PATH`` into ``BUILD_DIR`` on
    first use (and again when the source is newer than the library).
    Raises if it cannot be built or loaded."""
    src, out = SRC_PATH, os.path.join(BUILD_DIR, "libfastexport.so")
    with _lock:
        lib = _libs.get((src, out))
        if lib is not None:
            return lib
        try:
            if not os.path.isfile(src):
                raise FileNotFoundError(src)
            if (not os.path.isfile(out)
                    or os.path.getmtime(src) > os.path.getmtime(out)):
                _build(src, out)
            lib = ctypes.CDLL(out)
        except (OSError, RuntimeError) as e:
            raise RuntimeError(
                f"the native exporter could not be built or loaded ({e}); "
                "pass use_native=False for the Python writer") from e
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[(src, out)] = lib
        return lib


def _xyrra_in_um(xyrra_list):
    out = np.array(xyrra_list, dtype=np.float64, order="C", copy=True)
    out = out.reshape(-1, 5) if out.size else out.reshape(0, 5)
    out[:, 0:4] /= um
    return out


def _native_write(writer: str, filename: str, data, *args) -> str:
    rc = getattr(_native_lib(), writer)(
        filename.encode(), data.ctypes.data_as(_DOUBLES), data.shape[0],
        *args)
    if rc != 0:
        raise OSError(f"native {writer} failed with code {rc}")
    return filename


def make_dxf(xyrra_list, filename="test.dxf", ellipse_segments=16,
             use_native=True, progress=False):
    """Write a DXF file of the layout (reference ``make_dxf``/``make_dxf2``,
    ``design_collimator.py:317-361``)."""
    data = _xyrra_in_um(xyrra_list)
    if use_native:
        return _native_write("write_dxf_r12", filename, data,
                             ellipse_segments)
    with open(filename, "w") as f:
        f.write("0\nSECTION\n2\nENTITIES\n")
        for i, (x, y, rx, ry, a) in enumerate(data):
            if progress and i % 10000 == 0:
                print(data.shape[0] - i,
                      "ellipses remaining in dxf creation...", flush=True)
            if rx == ry:
                f.write(f"0\nCIRCLE\n8\n0\n10\n{x:.6f}\n20\n{y:.6f}\n"
                        f"40\n{rx:.6f}\n")
            else:
                f.write("0\nPOLYLINE\n8\n0\n66\n1\n70\n1\n")
                ts = np.linspace(0, 2 * pi, ellipse_segments, endpoint=False)
                dx, dy = rx * np.cos(ts), ry * np.sin(ts)
                ca, sa = np.cos(a), np.sin(a)
                for px, py in zip(x + dx * ca - dy * sa,
                                  y + dx * sa + dy * ca):
                    f.write(f"0\nVERTEX\n8\n0\n10\n{px:.6f}\n20\n{py:.6f}\n")
                f.write("0\nSEQEND\n")
        f.write("0\nENDSEC\n0\nEOF\n")
    return filename


# the reference's faster make_dxf2 is the same writer here
make_dxf2 = make_dxf


def _gds_real(v: float) -> bytes:
    """GDSII 8-byte real: sign bit, excess-64 base-16 exponent, 56-bit
    mantissa in [1/16, 1)."""
    if v == 0.0:
        return b"\x00" * 8
    sign = 0
    if v < 0:
        sign, v = 0x80, -v
    e = 0
    while v >= 1.0:
        v /= 16.0
        e += 1
    while v < 1.0 / 16.0:
        v *= 16.0
        e -= 1
    mant = int(v * 2 ** 56)      # truncate: matches canonical encoders
    if mant >= 2 ** 56:
        mant >>= 4
        e += 1
    return bytes([sign | (e + 64)]) + mant.to_bytes(7, "big")


def _gds_rec(rtype_dtype: int, data: bytes = b"") -> bytes:
    return ((len(data) + 4).to_bytes(2, "big")
            + rtype_dtype.to_bytes(2, "big") + data)


def make_gds(xyrra_list, filename="test.gds", ellipse_segments=64,
             layer=0, use_native=True):
    """Write a GDSII stream file of the layout: every pillar a closed
    BOUNDARY polygon of ``ellipse_segments`` vertices on ``layer``,
    database unit 1 nm, user unit 1 um, zeroed timestamps."""
    # checked before either writer: the native one would return an opaque
    # code (segments) or truncate the 16-bit layer field
    if not 3 <= ellipse_segments <= 8000:
        raise ValueError("ellipse_segments must be in [3, 8000] (the XY "
                         "record holds at most 8191 points)")
    if not 0 <= int(layer) <= 255:
        raise ValueError("layer must be in [0, 255] (GDSII layer range)")
    data = _xyrra_in_um(xyrra_list)
    if use_native:
        return _native_write("write_gds", filename, data, ellipse_segments,
                             layer)
    # the float association matches the native writer operation for
    # operation (cos(2*pi*k/S) bracketed so; radii scaled to nm before the
    # products), so the two writers agree byte for byte
    ts = 2 * pi * np.arange(ellipse_segments) / ellipse_segments
    ct, st = np.cos(ts), np.sin(ts)
    with open(filename, "wb") as f:
        f.write(_gds_rec(0x0002, (600).to_bytes(2, "big")))     # HEADER
        f.write(_gds_rec(0x0102, b"\x00" * 24))                 # BGNLIB
        f.write(_gds_rec(0x0206, b"METALENS"))                  # LIBNAME
        f.write(_gds_rec(0x0305, _gds_real(1e-3) + _gds_real(1e-9)))
        f.write(_gds_rec(0x0502, b"\x00" * 24))                 # BGNSTR
        f.write(_gds_rec(0x0606, b"LENS"))                      # STRNAME
        lay = int(layer).to_bytes(2, "big")
        dt = (0).to_bytes(2, "big")
        for x, y, rx, ry, a in data:
            ca, sa = np.cos(a), np.sin(a)
            dx, dy = (rx * 1000.0) * ct, (ry * 1000.0) * st     # um -> nm
            # round half away from zero, as the native writer's lround
            fx = x * 1000.0 + dx * ca - dy * sa
            fy = y * 1000.0 + dx * sa + dy * ca
            px = (np.sign(fx) * np.floor(np.abs(fx) + 0.5)).astype(np.int64)
            py = (np.sign(fy) * np.floor(np.abs(fy) + 0.5)).astype(np.int64)
            px = np.append(px, px[0])
            py = np.append(py, py[0])
            xy = np.empty(2 * px.size, dtype=">i4")
            xy[0::2], xy[1::2] = px, py
            f.write(_gds_rec(0x0800))                           # BOUNDARY
            f.write(_gds_rec(0x0D02, lay))                      # LAYER
            f.write(_gds_rec(0x0E02, dt))                       # DATATYPE
            f.write(_gds_rec(0x1003, xy.tobytes()))             # XY
            f.write(_gds_rec(0x1100))                           # ENDEL
        f.write(_gds_rec(0x0700))                               # ENDSTR
        f.write(_gds_rec(0x0400))                               # ENDLIB
    return filename


def make_svg(xyrra_list, filename="test.svg", use_native=True,
             progress=False):
    """Write an SVG file of the layout (reference ``make_svg``,
    ``design_collimator.py:363-381``)."""
    data = _xyrra_in_um(xyrra_list)
    if use_native:
        return _native_write("write_svg", filename, data)
    with open(filename, "w") as f:
        f.write('<?xml version="1.0" encoding="utf-8"?>\n'
                '<svg xmlns="http://www.w3.org/2000/svg" version="1.1">\n')
        for i, (x, y, rx, ry, a) in enumerate(data):
            if progress and i % 10000 == 0:
                print(data.shape[0] - i,
                      "ellipses remaining in svg creation...", flush=True)
            if rx == ry:
                f.write(f'<circle cx="{x:.6f}" cy="{y:.6f}" r="{rx:.6f}" />\n')
            else:
                deg = a * 180.0 / pi
                f.write(f'<ellipse cx="{x:.6f}" cy="{y:.6f}" rx="{rx:.6f}" '
                        f'ry="{ry:.6f}" transform="rotate({deg:.4f} '
                        f'{x:.6f} {y:.6f})" />\n')
        f.write("</svg>\n")
    return filename
