"""End-to-end demo on the port: design a miniature round collimator and
compute its focal performance.

The twin of ``examples/collimator_demo.py`` (the README workflow), with the
same stages, parameters and printed lines: grating -> optimize_gradient ->
vary_angle -> characterize -> HexGridSet -> make_design -> near field ->
far field -> DXF/SVG/GDSII export (the native writer).  It runs on CUDA
unless ``--cpu`` is given, and raises without a card.  Each stage prints
its wall time.

    python3 -m metalens_tpu_torch.examples.collimator_demo [--cpu]
        [--outdir DIR] [--numG N] [--rgb]

``--rgb`` also characterizes every cell at 450/650 nm (one joint sweep per
member) and reports the 580-nm-designed lens at all three wavelengths:
transmission, far-field peak and 0.1-cone power fraction.  The far-field
PNGs need matplotlib; without it the demo says so and goes on.
"""

import argparse
import math
import os
import time

import numpy as np


def _save_farfield_png(P, ux, uy, tag, path):
    """The far-field power map as a PNG; False when matplotlib is absent."""
    try:
        from metalens_tpu_torch.viz import _plt
        plt = _plt()
    except ImportError:
        return False
    Pz = P.detach().cpu().numpy()
    Pz = np.where(np.isfinite(Pz), Pz, 0.0)
    plt.figure(figsize=(5, 4))
    plt.imshow(np.log10(Pz.T + Pz.max() * 1e-8),
               extent=(ux.min(), ux.max(), uy.min(), uy.max()),
               origin="lower")
    plt.xlabel("ux"); plt.ylabel("uy")
    plt.title(f"far-field power (log10), {tag}")
    plt.colorbar()
    plt.savefig(path, dpi=120)
    plt.close()
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--outdir", default="demo_out")
    ap.add_argument("--numG", type=int, default=25)
    ap.add_argument("--rgb", action="store_true",
                    help="also characterize at 450/650 nm (one joint sweep "
                         "per member) and evaluate the lens chromatically")
    args = ap.parse_args(argv)

    from metalens_tpu_torch import Grating, HexGridSet
    from metalens_tpu_torch.optimize import optimize_gradient, vary_angle
    from metalens_tpu_torch.assembly import make_design
    from metalens_tpu_torch.nearfield import build_nearfield
    from metalens_tpu_torch.farfield import farfield, focal_metrics
    from metalens_tpu_torch.export import make_dxf, make_gds, make_svg
    from metalens_tpu_torch.geometry import good_fft_number
    from metalens_tpu_torch.solver.cpx import resolve_device
    from metalens_tpu_torch.solver.fom import FomTerm
    from metalens_tpu_torch.units import nm, um, degree

    dev = resolve_device("cpu" if args.cpu else "cuda")
    os.makedirs(args.outdir, exist_ok=True)
    LAM = 580 * nm
    terms = [FomTerm(LAM, 1.0, -1, True)]
    d = 25 * um          # source distance
    radius = 10.9 * um   # lens radius: holds 4 Fresnel-zone periphery rings
    stage_s = {}

    # --- 1. an optimized deflector cell at the innermost periphery angle
    # (vary_angle for round lenses runs inside -> outside) ---
    t0 = time.time()
    ang0 = 14 * degree   # innermost periphery ring sits at ~14.6 deg
    lp_over_tan = 320 * nm / math.tan(ang0)
    g0 = Grating(lateral_period=lp_over_tan * math.tan(ang0),
                 cyl_height=550 * nm, target_wavelength=LAM,
                 angle_in_air=ang0,
                 xyrra_list_in_nm_deg=np.array([[-200., 0., 95., 75., 0.],
                                                [300., 0., 75., 85., 0.]]))
    def fom(g):
        return g.fom(target_wavelength=LAM, numG=args.numG, terms=terms,
                     device=dev)
    print(f"start fom: {fom(g0):.4f}")
    g0 = optimize_gradient(g0, target_wavelength=LAM, numG=args.numG,
                           terms=terms, steps=40, verbose=False, device=dev)
    stage_s["optimize"] = time.time() - t0
    print(f"optimized fom: {fom(g0):.4f}  ({stage_s['optimize']:.0f}s)")

    # --- 2. continuation outward to the outermost ring's period ---
    t0 = time.time()
    end_angle = 27.7 * degree
    gc = vary_angle(start_grating=g0, end_angle=end_angle,
                    lens_type="round", target_wavelength=LAM,
                    numG=args.numG, terms=terms, use_gradient=True,
                    gradient_steps=15, optimize2_attempts=3, verbose=False,
                    device=dev)
    stage_s["vary_angle"] = time.time() - t0
    print(f"collection: {len(gc.grating_list)} members "
          f"({stage_s['vary_angle']:.0f}s)")

    # --- 3. amplitude databases ---
    t0 = time.time()
    gc.characterize(LAM, numG=args.numG, u_steps=3, device=dev)
    gc.build_interpolators(device=dev)
    hgs = HexGridSet(sep=320 * nm, cyl_height=550 * nm, num_entries=8)
    hgs.characterize(wavelength=LAM, numG=args.numG, just_normal=False,
                     u_steps=3, device=dev)
    hgs.build_interpolators(device=dev)
    stage_s["characterize"] = time.time() - t0
    print(f"characterized ({stage_s['characterize']:.0f}s)")

    # --- 4. assemble the lens; the bracket starts at 12 deg so the
    # innermost Fresnel zero (r ~ 5.4um, 12.2 deg) passes design_periphery's
    # angle threshold ---
    t0 = time.time()
    outer_angle = gc.get_outermost().get_angle_in_air(LAM)
    lps, lcs, r_switch, xyrra = make_design(
        [[(12 * degree, outer_angle + 0.5 * degree), gc]],
        d, radius, hgs, make_xyrra_list=True)
    stage_s["design"] = time.time() - t0
    print(f"lens: {xyrra.shape[0]} pillars, {len(lps['r_center_list'])} "
          f"rings, center r={r_switch/um:.2f}um")
    t0 = time.time()
    for make, name in ((make_dxf, "collimator.dxf"),
                       (make_svg, "collimator.svg"),
                       (make_gds, "collimator.gds")):
        make(xyrra, os.path.join(args.outdir, name), use_native=True)
    stage_s["export"] = time.time() - t0

    # --- 4b. RGB databases for chromatic evaluation (--rgb); the design
    # stays the 580-optimized geometry ---
    eval_lams = [LAM]
    if args.rgb:
        t0 = time.time()
        gc.characterize([450 * nm, 650 * nm], numG=args.numG, u_steps=3,
                        append=True, device=dev)
        gc.build_interpolators(device=dev)
        hgs.characterize(wavelength=[450 * nm, 650 * nm], numG=args.numG,
                         just_normal=False, u_steps=3, append=True,
                         device=dev)
        hgs.build_interpolators(device=dev)
        eval_lams = [450 * nm, LAM, 650 * nm]
        stage_s["rgb"] = time.time() - t0
        print(f"RGB databases ({stage_s['rgb']:.0f}s)")

    # --- 5. near field + far field (per evaluation wavelength) ---
    t0 = time.time()
    half = radius * 1.05
    for lam in eval_lams:
        n_pts = good_fft_number(2 * half / (lam / 2.2))
        x_pts = np.linspace(-half, half, n_pts)
        Ex, Ey, Hx, Hy, xs, ys, P_lens, ng = build_nearfield(
            0.0, 0.0, -d, "x", lam, lps, lcs, hgs, x_pts, x_pts,
            dipole_moment=1e-30, device=dev)
        P, total_P, ux, uy, dux, duy = farfield(Ex, Ey, Hx, Hy, xs, ys,
                                                lam, ng, device=dev)
        m = focal_metrics(P, ux, uy, dux, duy, total_P, P_lens,
                          spot_radius_u=0.1)
        tag = f"{round(lam/nm)}nm"
        print(f"[{tag}] transmission: {m['transmission']:.3f}  "
              f"peak (ux, uy) = ({m['peak_ux']:.3f}, {m['peak_uy']:.3f})  "
              f"0.1-cone fraction: {m['spot_fraction_of_total']:.3f}")
        if not _save_farfield_png(P, ux, uy, tag, os.path.join(
                args.outdir, f"farfield_{tag}.png")):
            print(f"plot skipped: no matplotlib, farfield_{tag}.png not made")
    stage_s["fields"] = time.time() - t0
    print(f"near+far field ({stage_s['fields']:.0f}s)")
    print(f"wrote {args.outdir}/farfield_*.png, collimator.dxf, "
          f"collimator.svg, collimator.gds")
    print("stage times (s): " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in stage_s.items()))


if __name__ == "__main__":
    main()
