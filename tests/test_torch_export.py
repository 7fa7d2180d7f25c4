"""The port's fabrication export against the JAX package's writers.

The port's Python writers must write the JAX package's bytes for DXF, SVG
and GDSII, and the port's native writer (``native/fastexport.cpp``, built
into ``build/fastexport/``) the Python writers' bytes.  ``use_native=True``
raises when the native library cannot be built; it never falls back.
"""

import os
import struct

import numpy as np
import pytest
import torch

from metalens_tpu import export as jexport
from metalens_tpu_torch import export

torch.set_num_threads(1)

NM, UM = 1e-9, 1e-6
XYRRA = np.array([
    [0.0, 0.0, 100 * NM, 100 * NM, 0.0],            # circle
    [500 * NM, -200 * NM, 150 * NM, 80 * NM, 0.3],  # rotated ellipse
    [-1 * UM, 1 * UM, 60 * NM, 60 * NM, 0.0],
    [2.5 * UM, -0.7 * UM, 93.25 * NM, 71.5 * NM, -1.1],
])
WRITERS = {"dxf": (export.make_dxf, jexport.make_dxf),
           "svg": (export.make_svg, jexport.make_svg),
           "gds": (export.make_gds, jexport.make_gds)}


def _layout(n, seed=0):
    """n pillars on a 2 mm square: circles and rotated ellipses."""
    rng = np.random.default_rng(seed)
    xyrra = np.zeros((n, 5))
    xyrra[:, 0:2] = rng.uniform(-1e-3, 1e-3, size=(n, 2))
    xyrra[:, 2] = rng.uniform(50, 150, n) * NM
    xyrra[:, 3] = np.where(rng.random(n) < 0.5, xyrra[:, 2],
                           rng.uniform(50, 150, n) * NM)
    xyrra[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return xyrra


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_python_writer_matches_jax(tmp_path, fmt):
    ours, theirs = WRITERS[fmt]
    for xyrra, tag in ((XYRRA, "small"), (_layout(300), "random")):
        p1 = str(tmp_path / f"port_{tag}.{fmt}")
        p2 = str(tmp_path / f"jax_{tag}.{fmt}")
        ours(xyrra, p1, use_native=False)
        theirs(xyrra, p2, use_native=False)
        assert _read(p1) == _read(p2), (fmt, tag)


def test_gds_real_matches_jax():
    for v in (0.0, 1.0, -1.0, 0.25, 1e-3, 1e-9, 2.5e7, -3.1e-11, 7.0 / 3):
        assert export._gds_real(v) == jexport._gds_real(v)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_native_writer_matches_python(tmp_path, fmt):
    make = WRITERS[fmt][0]
    xyrra = np.concatenate([XYRRA, _layout(2000, seed=1)])
    p1, p2 = str(tmp_path / f"n.{fmt}"), str(tmp_path / f"p.{fmt}")
    make(xyrra, p1, use_native=True)
    make(xyrra, p2, use_native=False)
    assert _read(p1) == _read(p2)
    assert os.path.isfile(os.path.join(export.BUILD_DIR, "libfastexport.so"))


def _gds_boundaries(path):
    """Minimal GDSII record walk: the (layer, XY) of every BOUNDARY."""
    raw = _read(path)
    i, layer, polygons = 0, None, []
    while i < len(raw):
        length, rt_dt = struct.unpack(">HH", raw[i:i + 4])
        assert length >= 4
        if rt_dt == 0x0D02:
            (layer,) = struct.unpack(">H", raw[i + 4:i + 6])
        elif rt_dt == 0x1003:
            xy = np.frombuffer(raw[i + 4:i + length], dtype=">i4")
            polygons.append((layer, xy.astype(np.int64).reshape(-1, 2)))
        i += length
    assert i == len(raw)
    return polygons


@pytest.mark.parametrize("use_native", [True, False])
def test_gds_polygons_lie_on_the_ellipses(tmp_path, use_native):
    path = str(tmp_path / "a.gds")
    export.make_gds(XYRRA, path, ellipse_segments=32, layer=3,
                    use_native=use_native)
    polygons = _gds_boundaries(path)
    assert len(polygons) == len(XYRRA)
    for (layer, xy), (x0, y0, rx, ry, a) in zip(polygons, XYRRA):
        assert layer == 3 and xy.shape == (33, 2) and (xy[0] == xy[-1]).all()
        dx, dy = xy[:-1, 0] * NM - x0, xy[:-1, 1] * NM - y0
        xp = dx * np.cos(a) + dy * np.sin(a)
        yp = -dx * np.sin(a) + dy * np.cos(a)
        assert np.allclose((xp / rx) ** 2 + (yp / ry) ** 2, 1.0, atol=0.05)


@pytest.mark.parametrize("use_native", [True, False])
def test_empty_and_1d_inputs(tmp_path, use_native):
    """An empty layout writes a valid, pillar-free file; a bare
    [x, y, rx, ry, a] row is one pillar -- the same bytes as JAX's."""
    one = [0.1e-6, -0.2e-6, 0.05e-6, 0.04e-6, 0.3]
    for fmt, (ours, theirs) in WRITERS.items():
        for xyrra, tag in (([], "empty"), (one, "one")):
            p1 = str(tmp_path / f"{tag}.{fmt}")
            p2 = str(tmp_path / f"{tag}_jax.{fmt}")
            ours(xyrra, p1, use_native=use_native)
            theirs(xyrra, p2, use_native=False)
            assert os.path.getsize(p1) > 0
            assert _read(p1) == _read(p2), (fmt, tag)


@pytest.mark.parametrize("use_native", [True, False])
def test_gds_refuses_bad_arguments(tmp_path, use_native):
    xyrra = np.array([[0.0, 0.0, 100e-9, 100e-9, 0.0]])
    for kw in ({"ellipse_segments": 2}, {"ellipse_segments": 9000},
               {"layer": -1}, {"layer": 300}):
        with pytest.raises(ValueError):
            export.make_gds(xyrra, str(tmp_path / "bad.gds"),
                            use_native=use_native, **kw)


@pytest.mark.parametrize("source", ["missing", "broken"])
def test_native_build_failure_raises(tmp_path, monkeypatch, source):
    """No silent fallback: a source that is missing or does not compile
    makes use_native=True raise and name use_native=False."""
    src = tmp_path / "fastexport.cpp"
    if source == "broken":
        src.write_text("this is not C++\n")
    monkeypatch.setattr(export, "SRC_PATH", str(src))
    monkeypatch.setattr(export, "BUILD_DIR", str(tmp_path / "build"))
    for fmt, (make, _) in WRITERS.items():
        with pytest.raises(RuntimeError, match="use_native=False"):
            make(XYRRA, str(tmp_path / f"x.{fmt}"), use_native=True)
        make(XYRRA, str(tmp_path / f"x.{fmt}"), use_native=False)
