"""Multi-device near-field assembly.

Counterpart of ``metalens_tpu/parallel/nearfield.py``.  The stitcher is
embarrassingly parallel over aperture points, so the reference's RAM-slab
loop (``nearfield.py:482-516``) becomes one slab per rank: each rank
stitches a contiguous block of the aperture's x points with the port's
:func:`metalens_tpu_torch.nearfield.build_nearfield` on its own device,
from amplitude tables it holds there, with no collective until the
fields are gathered at the end.  The JAX package's ``sharding=`` knob of
``build_nearfield`` places one program's arrays on devices; it has no
counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import nearfield as nf
from .mesh import Mesh, make_mesh


def build_nearfield_sharded(mesh_or_devices, source_x, source_y, source_z,
                            source_pol, wavelength, lens_periphery_summary,
                            lens_center_summary, hexgridset, x_pts=None,
                            y_pts=None, dipole_moment=1e-30):
    """:func:`metalens_tpu_torch.nearfield.build_nearfield` over the ranks
    of a mesh (or of ``make_mesh(devices=...)`` for a device list), split
    by blocks of ``x_pts``: every rank passes the same arguments, with the
    collections' and the hexgrid set's tables on its own device.  Returns
    host numpy complex fields of the whole aperture, all-gathered, and the
    usual extras; the power through the lens is summed over the ranks in
    float64."""
    mesh = (mesh_or_devices if isinstance(mesh_or_devices, Mesh)
            else make_mesh(devices=list(mesh_or_devices)))
    if x_pts is None or y_pts is None:
        lens_max_r = nf._lens_max_radius(lens_periphery_summary,
                                         lens_center_summary, hexgridset)
        if x_pts is None:
            x_pts = nf._default_aperture_pts(wavelength, lens_max_r)
        if y_pts is None:
            y_pts = nf._default_aperture_pts(wavelength, lens_max_r)
    x_pts, y_pts = np.asarray(x_pts), np.asarray(y_pts)
    nx = len(x_pts)
    # contiguous blocks of at most `rows` points; build_nearfield takes
    # the grid step from a block's first two points
    rows = -(-nx // mesh.size)
    lo, hi = min(mesh.rank * rows, nx), min((mesh.rank + 1) * rows, nx)
    if nx - (mesh.size - 1) * rows < 2:
        raise ValueError(f"{nx} aperture rows leave a rank fewer than 2 of "
                         f"{mesh.size} blocks of {rows}")
    Ex, Ey, Hx, Hy, _, _, power, n_glass = nf.build_nearfield(
        source_x, source_y, source_z, source_pol, wavelength,
        lens_periphery_summary, lens_center_summary, hexgridset,
        x_pts[lo:hi], y_pts, dipole_moment=dipole_moment,
        device=mesh.device)
    fields = torch.stack([Ex, Ey, Hx, Hy])
    if hi - lo < rows:       # the last block, padded to the common size
        fields = torch.cat([fields, fields.new_zeros(
            (4, rows - (hi - lo), len(y_pts)))], dim=1)
    fields = mesh.all_gather(fields.transpose(0, 1).contiguous())
    fields = fields[:nx].transpose(0, 1).cpu().numpy()
    total = mesh.all_reduce(torch.tensor([power], dtype=torch.float64))
    return (*fields, x_pts, y_pts, float(total[0]), n_glass)
