"""HexGridSet: the lens-center pillar library.

Counterpart of ``metalens_tpu/hexgrid.py``.  A set of hexagonal-lattice
circular-pillar unit cells spanning a range of diameters; the center of the
lens picks, per site, the diameter whose transmission phase best matches
the target phase profile.  The characterize sweep of each member is one
batched solve on the port's engine.  The ``repr`` is the JAX package's, so
a spec written by either package evaluates in the other.
"""

from __future__ import annotations

import numpy as np

from .grating import Grating, validate
from .materials import n_glass as n_glass_table
from .units import nm


class HexGridSet:
    """A set of geometries for the center of the lens.

    Each entry is a rectangular supercell of the hexagonal lattice with
    nearest-neighbor separation ``sep``: cell ``sqrt(3)*sep x sep`` holding
    two circular pillars at (0,0) and (sqrt(3)/2*sep, sep/2).  Diameters
    run linspace(100.01nm, sep-100.01nm, num_entries).
    """

    def __init__(self, sep, cyl_height, n_glass=0, n_tio2=0,
                 grating_list=None, x_amp_list=None, num_entries=20):
        self.sep = sep
        self.nnn_sep = self.sep * 3 ** 0.5   # next-nearest-neighbor distance
        self.cyl_height = cyl_height
        self.n_glass = n_glass
        self.n_tio2 = n_tio2
        if grating_list is not None:
            self.grating_list = grating_list
        else:
            self.grating_list = []
            for diam in np.linspace(100.01 * nm, self.sep - 100.01 * nm,
                                    num=num_entries):
                r = diam / 2
                xyrra_list_in_nm_deg = [
                    [0, 0, r / nm, r / nm, 0],
                    [self.nnn_sep / 2 / nm, self.sep / 2 / nm, r / nm, r / nm, 0]]
                g = Grating(grating_period=self.nnn_sep,
                            lateral_period=self.sep,
                            n_glass=self.n_glass, n_tio2=self.n_tio2,
                            cyl_height=self.cyl_height,
                            xyrra_list_in_nm_deg=np.array(xyrra_list_in_nm_deg))
                assert validate(g)
                self.grating_list.append(g)
        if x_amp_list is not None:
            self.x_amp_list = np.array(x_amp_list)

    def __repr__(self):
        if hasattr(self, "x_amp_list"):
            x_amp_list_str = (np.array2string(self.x_amp_list, separator=",",
                                              threshold=int(1e9),
                                              max_line_width=int(1e9))
                              .replace(" ", "").replace("\n", ""))
            x_amp_list_str = "np.array(" + x_amp_list_str + ")"
        else:
            x_amp_list_str = "None"
        return ("HexGridSet("
                + "sep=" + repr(self.sep / nm) + "*nm"
                + ", cyl_height=" + repr(self.cyl_height / nm) + "*nm"
                + ", n_glass=" + repr(self.n_glass)
                + ", n_tio2=" + repr(self.n_tio2)
                + ", grating_list= " + repr(self.grating_list)
                + ", x_amp_list=" + x_amp_list_str
                + ")")

    def characterize(self, wavelength=580 * nm, numG=100, just_normal=True,
                     shortcut=False, u_steps=3, append=False, *,
                     device="cuda", dtype=None):
        """Fill every member's amplitude database (one batched solve per
        member) and compile ``x_amp_list``, the phase library of the lens
        center: each member's (0,0)-order forward 'x' amplitude at the
        (0.001, 0.001) direction.  ``append=True`` accumulates an RGB
        database; ``x_amp_list`` is taken at the first wavelength of this
        call.  ``shortcut`` (fill one quadrant and mirror) is not
        implemented, as in the JAX package.  Runs on CUDA unless
        ``device="cpu"``."""
        assert shortcut is False, "symmetry shortcut unnecessary on device"
        if just_normal is True:
            u_args = dict(ux_min=0.001, ux_max=0.001, uy_min=0.001,
                          uy_max=0.001, u_steps=1)
        else:
            u_args = dict(ux_min=-0.499, ux_max=0.501, uy_min=-0.499,
                          uy_max=0.501, u_steps=2 * u_steps - 1)
        for g in self.grating_list:
            g.characterize(wavelength=wavelength, numG=numG,
                           just_normal=just_normal, append=append,
                           device=device, dtype=dtype, **u_args)

        lam0 = wavelength if np.ndim(wavelength) == 0 else wavelength[0]
        wl_nm = round(lam0 / nm)
        x_amp_list = []
        for g in self.grating_list:
            # the (0.001, 0.001) sample, matched with a tolerance: off the
            # just_normal path the grid midpoint carries round-off
            a = [e for e in g.data if e["x_or_y"] == "x"
                 and e["ox"] == e["oy"] == 0
                 and round(e["wavelength_in_nm"]) == wl_nm
                 and abs(e["ux"] - 0.001) < 1e-9
                 and abs(e["uy"] - 0.001) < 1e-9]
            assert len(a) == 1
            x_amp_list.append(a[0]["ampfx"])
        self.x_amp_list = np.array(x_amp_list)

    def show_properties(self):
        """Plot transmission and phase against pillar diameter at normal
        incidence (reference ``lens_center.py:158-173``; needs
        matplotlib)."""
        from .viz import _plt
        plt = _plt()
        d_list = np.array([2 * g.xyrra_list[0, 2] for g in self.grating_list])
        x_amp_list = self.x_amp_list
        if self.grating_list[0].n_glass == 0:
            ng = n_glass_table(self.grating_list[0].data[0]["wavelength_in_nm"])
        else:
            ng = self.grating_list[0].n_glass
        fig, ax1 = plt.subplots()
        Ts = abs(x_amp_list) ** 2 / ng
        phases = np.unwrap(np.angle(x_amp_list))
        ax1.plot(d_list / nm, Ts, "b")
        ax1.set_ylim(0, 1)
        plt.title("T and phase at normal incidence")
        plt.xlabel("diameter")
        ax2 = ax1.twinx()
        ax2.plot(d_list / nm, phases, "g")
        return fig

    def pick_from_phase(self, target_phase):
        """Best member index for a target phase: argmax of
        Im(x_amp * e^{-i phi}), which rewards transmission and phase match
        together."""
        if not hasattr(self, "x_amp_list"):
            raise ValueError("Need to run characterize() first")
        fom_list = (self.x_amp_list * np.exp(-1j * target_phase)).imag
        return int(np.argmax(fom_list))

    def save(self, path):
        """Binary persistence (see
        :mod:`metalens_tpu_torch.serialization`)."""
        from .serialization import save
        return save(self, path)

    def build_interpolators(self, *, device="cuda"):
        """(ux, uy, member-index) -> complex amplitude tables, all four
        amplitude kinds, on ``device`` (CUDA unless ``device="cpu"``)."""
        if not hasattr(self, "x_amp_list"):
            raise ValueError("Need to run characterize() first")
        from .characterize import build_hexgrid_interpolators
        self.interpolators, self.interpolator_bounds = \
            build_hexgrid_interpolators(self, device=device)
        return self.interpolators
