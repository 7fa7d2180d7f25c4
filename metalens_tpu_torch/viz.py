"""Matplotlib diagnostics on the port's objects.

Counterpart of ``metalens_tpu/viz.py``: unit-cell and characterization
plots, the analytic eps map, the collection's frames and the far- and
near-field maps.  matplotlib is imported lazily (Agg backend) by
:func:`_plt`, so nothing else of the port needs it; tensors are moved to the
host before plotting, and nothing here runs inside a device path.
"""

from __future__ import annotations

import numpy as np
import torch

from .units import nm, degree


def _host(x):
    """A tensor or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def show_config(grating):
    """Unit-cell plot with periodic replicas (reference ``grating.py:344-362``)."""
    plt = _plt()
    import matplotlib.patches
    grating_period = grating.grating_period
    lateral_period = grating.lateral_period
    fig = plt.figure()
    plt.xlim(-grating_period / nm, grating_period / nm)
    plt.ylim(-lateral_period / nm, lateral_period / nm)
    for x, y, rx, ry, a in grating.get_xyrra_list(replicas=3):
        ell = matplotlib.patches.Ellipse((x / nm, y / nm), 2 * rx / nm,
                                         2 * ry / nm, angle=a / degree,
                                         color="k", alpha=0.5)
        plt.gcf().gca().add_artist(ell)
    rect = matplotlib.patches.Rectangle(
        (-grating_period / 2 / nm, -lateral_period / 2 / nm),
        grating_period / nm, lateral_period / nm, facecolor="none",
        linestyle="dashed", linewidth=2, edgecolor="red")
    plt.gcf().gca().add_artist(rect)
    plt.gcf().gca().set_aspect("equal")
    return fig


def show_characterization(mygrating, my_order=(0, 0), my_pol="x",
                          my_wavelength=580, which_amp="amprx"):
    """Amplitude-vs-angle heatmap (reference ``grating.py:480-505``)."""
    plt = _plt()
    all_data = mygrating.data
    ux_list = sorted({x["ux"] for x in all_data})
    uy_list = sorted({x["uy"] for x in all_data})
    filt = [x for x in all_data if x["x_or_y"] == my_pol
            and x["ox"] == my_order[0] and x["oy"] == my_order[1]
            and x["wavelength_in_nm"] == my_wavelength]
    data = np.zeros((len(ux_list), len(uy_list)), dtype=complex) + np.nan
    for entry in filt:
        ix = ux_list.index(entry["ux"])
        iy = uy_list.index(entry["uy"])
        data[ix, iy] = entry[which_amp]
    fig = plt.figure()
    plt.imshow(np.abs(data).T, interpolation="none",
               extent=(min(ux_list), max(ux_list), min(uy_list), max(uy_list)))
    plt.xlabel("ux (x-component of unit vector of incoming light direction)")
    plt.ylabel("uy (y-component of unit vector of incoming light direction)")
    plt.colorbar()
    return fig


def correct_imshow_extent(array, min_px_center_x, max_px_center_x,
                          min_px_center_y, max_px_center_y):
    """imshow extent giving coordinates at pixel *centers* (reference
    ``grating.py:652-663``)."""
    nx = array.shape[1]
    ny = array.shape[0]
    px_extent_x = (max_px_center_x - min_px_center_x) / (nx - 1)
    px_extent_y = (max_px_center_y - min_px_center_y) / (ny - 1)
    return [min_px_center_x - px_extent_x / 2,
            max_px_center_x + px_extent_x / 2,
            min_px_center_y - px_extent_y / 2,
            max_px_center_y + px_extent_y / 2]


def eps_map(grating, wavelength=580e-9, n_points=101):
    """The permittivity map of the pillar layer, evaluated *analytically*
    (real-space indicator sum) on a grid -- replaces the reference's
    plot_eps which parses a temp file written by a commented-out Lua hook
    (reference ``grating.py:797-812``, ``grating.lua:339-350``).
    Returns (eps_matrix, xs, ys); plot with :func:`plot_eps`."""
    from .materials import resolve_indices
    ng, nt = resolve_indices(grating.n_glass, grating.n_tio2, wavelength)
    Lx, Ly = grating.grating_period, grating.lateral_period
    xs = np.linspace(-Lx / 2, Lx / 2, n_points)
    ys = np.linspace(-Ly / 2, Ly / 2, n_points)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    eps = np.ones_like(X, dtype=complex)
    for x0, y0, rx, ry, a in grating.xyrra_list:
        for sx_ in (-1, 0, 1):
            for sy_ in (-1, 0, 1):
                dx, dy = X - x0 + sx_ * Lx, Y - y0 + sy_ * Ly
                u = (dx * np.cos(a) + dy * np.sin(a)) / rx
                v = (-dx * np.sin(a) + dy * np.cos(a)) / ry
                eps = np.where(u ** 2 + v ** 2 <= 1, complex(nt) ** 2, eps)
    return eps, xs, ys


def plot_eps(grating, wavelength=580e-9, n_points=101):
    """Index-map plot of the unit cell (reference ``grating.py:797-812``)."""
    plt = _plt()
    eps, xs, ys = eps_map(grating, wavelength, n_points)
    fig = plt.figure()
    plt.imshow(np.sqrt(eps.real).T, origin="lower", aspect="equal",
               extent=(xs.min() / nm, xs.max() / nm,
                       ys.min() / nm, ys.max() / nm))
    plt.title("index")
    plt.colorbar()
    return fig


def plot_round_lateral_period(f, reps_around_circumference,
                              target_wavelength=580e-9):
    """Design study: how lateral_period and grating_period covary across a
    round lens (reference ``grating.py:1243-1270``)."""
    plt = _plt()
    d = np.linspace(100e-9, f * 5, num=1000)
    angles = np.arctan(d / f)
    lateral_periods = 2 * np.pi * d / reps_around_circumference
    grating_periods = target_wavelength / np.sin(angles)
    figs = []
    fig = plt.figure()
    plt.plot(lateral_periods / nm, grating_periods / nm)
    plt.xlabel("lateral period (nm)")
    plt.ylabel("grating period (nm)")
    plt.xlim(0, 800); plt.ylim(0, 2000); plt.grid()
    figs.append(fig)
    fig = plt.figure()
    plt.plot(lateral_periods / nm, angles / degree)
    plt.xlabel("lateral period (nm)")
    plt.ylabel("angle (degree)")
    plt.xlim(0, 800); plt.grid()
    figs.append(fig)
    return figs


def plot_angle_efficiencies(angles_efficiencies_list):
    plt = _plt()
    fig = plt.figure()
    plt.plot([x[0] / degree for x in angles_efficiencies_list],
             [x[1] for x in angles_efficiencies_list])
    plt.xlabel("angle in air (deg)")
    plt.ylabel("figure of merit")
    return fig


def show_collection_graphs(gc, with_efficiencies=False,
                           anim_filename="grating_collection_anim.gif",
                           numG=100, *, device="cuda", dtype=None):
    """Per-member config plots (reference ``grating.py:1095-1135``) saved as
    PNG frames in the working directory (returned), and, if PIL is
    present, the GIF.  ``with_efficiencies`` titles each frame with its
    FOM, solved on ``device`` (CUDA unless ``device="cpu"``)."""
    plt = _plt()
    max_gp = max(g.grating_period for g in gc.grating_list)
    max_lp = max(g.lateral_period for g in gc.grating_list)
    effs = None
    if with_efficiencies:
        from .engine import fom_of_gratings
        effs = fom_of_gratings(gc.grating_list[::-1],
                               target_wavelength=gc.target_wavelength,
                               numG=numG, device=device, dtype=dtype)
    filenames = []
    for i, g in enumerate(gc.grating_list[::-1]):
        show_config(g)
        plt.xlim(-max_gp / nm, max_gp / nm)
        plt.ylim(-max_lp / nm, max_lp / nm)
        angle = g.get_angle_in_air(gc.target_wavelength) / degree
        if effs is not None:
            plt.title("From angle: {:.1f} deg, effic={:.2%}".format(angle, effs[i]))
        else:
            plt.title("From angle: {:.1f} deg".format(angle))
        fname = f"grating_collection{i}.png"
        plt.savefig(fname)
        plt.close()
        filenames.append(fname)
    if anim_filename:
        try:
            from PIL import Image
            frames = [Image.open(f) for f in filenames]
            frames[0].save(anim_filename, save_all=True,
                           append_images=frames[1:], duration=300, loop=0)
        except ImportError:
            pass  # PIL unavailable: keep the PNG frames
    return filenames


def plot_farfield(P, ux, uy, n_glass=1.0, log_floor=1e-6, title=None):
    """Angular power map of a far field (output of
    :func:`metalens_tpu_torch.farfield.farfield`, tensors or arrays) on the
    (ux, uy) direction-cosine disk, log-scaled over ``log_floor`` of the
    peak, with the |u| = 1 and |u| = 1/n_glass (air-escape /
    total-internal-reflection) circles drawn.

    The reference had no far-field plot at all -- its only pattern check
    was plotting near-field phase by hand (``lens_center.py:181-184``).
    Returns the figure."""
    plt = _plt()
    P = _host(P).astype(float)
    P = np.where(np.isfinite(P), P, 0.0)
    ux = _host(ux).reshape(-1)
    uy = _host(uy).reshape(-1)
    # DFT ordering isn't monotone: sort both axes for imshow
    ix, iy = np.argsort(ux), np.argsort(uy)
    P = P[np.ix_(ix, iy)]
    ux, uy = ux[ix], uy[iy]
    peak = P.max()
    img = np.log10(np.maximum(P / peak, log_floor) if peak > 0 else
                   np.full_like(P, log_floor))
    fig = plt.figure()
    plt.imshow(img.T, origin="lower", aspect="equal",
               extent=correct_imshow_extent(img.T, ux[0], ux[-1],
                                            uy[0], uy[-1]),
               cmap="inferno", vmin=np.log10(log_floor), vmax=0.0)
    plt.colorbar(label="log10(P / peak)")
    th = np.linspace(0, 2 * np.pi, 361)
    plt.plot(np.cos(th), np.sin(th), "w--", lw=0.8)
    if n_glass > 1.0:
        plt.plot(np.cos(th) / n_glass, np.sin(th) / n_glass, "c:", lw=0.8)
    plt.xlabel("ux")
    plt.ylabel("uy")
    if title:
        plt.title(title)
    return fig


def plot_nearfield(Ex, x_pts, y_pts, kind="phase", title=None):
    """Near-field map over the aperture: ``kind`` in ('phase', 'abs',
    'power').  ``Ex`` may be a complex tensor or a host complex array (any
    one field component / Poynting map).

    This is the reference's center/periphery phase-alignment calibration
    made reusable (``lens_center.py:181-184``, ``design_collimator.py:
    132-135`` plot near-field phase by hand to verify the +pi hex-grid
    convention and ring seams).  Returns the figure."""
    plt = _plt()
    arr = _host(Ex)
    if kind == "phase":
        img, cmap, label = np.angle(arr), "twilight", "arg(Ex) [rad]"
    elif kind == "abs":
        img, cmap, label = np.abs(arr), "viridis", "|Ex|"
    elif kind == "power":
        img, cmap, label = np.abs(arr) ** 2, "inferno", "|Ex|^2"
    else:
        raise ValueError(f"kind must be 'phase', 'abs' or 'power': {kind!r}")
    x_pts = _host(x_pts)
    y_pts = _host(y_pts)
    fig = plt.figure()
    plt.imshow(img.T, origin="lower", aspect="equal",
               extent=correct_imshow_extent(img.T, x_pts[0] / 1e-6,
                                            x_pts[-1] / 1e-6,
                                            y_pts[0] / 1e-6,
                                            y_pts[-1] / 1e-6),
               cmap=cmap)
    plt.colorbar(label=label)
    plt.xlabel("x [um]")
    plt.ylabel("y [um]")
    if title:
        plt.title(title)
    return fig
