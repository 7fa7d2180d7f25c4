"""The lens check of the configuration's round collimator at one wavelength,
repeated: the assembly on the host, the near-field stitch, the far field.

Set-up makes the lens's members from the seed: each bracket an unoptimized
collection of ``bracket_members`` two-pillar members
(``gen.round_brackets``) with normal noise of ``perturb_m`` on the
pillars, and the hexagonal centre's ``hex_entries`` circular-pillar cells.  It
characterizes them through the port (``GratingCollection.characterize``,
``HexGridSet.characterize`` at the characterize numG and u_steps) and
builds their interpolators.  A unit is one lens check: ``make_design``
with the pillar list, ``build_nearfield`` for an 'x' dipole at the source
distance on ``aperture_pts`` x ``aperture_pts`` points over
``aperture_scale`` times the radius, ``farfield`` and ``focal_metrics``.

The check compares one check of the window, drawn from the seed, and the
databases with the plain reference (``reference/lens.py``) in complex128:

* ``db_err``: the widest gap of any forward amplitude of any member's
  database; ``db_med_err``: the median over the members of each one's
  widest gap;
* ``pick_loss``: at the centre site where it is largest, how far the
  reference's score of the member the program put there lies below the
  reference's best;
* ``layout_miss``: rings, centre sites and pillars that differ from the
  reference's (float64 rounding aside);
* ``stitch_err``: the stitch by itself -- the widest gap of the near field
  (Ex, Ey, Hx, Hy), as a share of each field's largest value, against the
  reference's stitch of the program's own databases and layout;
* end to end, against the reference's lens from its own databases (with
  the program's centre members where ``pick_loss`` allows them):
  ``ff_err``, the widest gap of the angular power density as a share of
  its peak, and ``focal_gap``, the larger gap of the transmission and of
  the spot's share.
"""

from __future__ import annotations

import contextlib
import io
import math

import numpy as np
import torch

from portbench import gen
from portbench.reference import lens as rl
from portbench.reference import rcwa as ref
from portbench.reference.fom import index
from portbench.runner import passed

NUMBERS = ("db_err", "db_med_err", "pick_loss", "layout_miss", "stitch_err",
           "ff_err", "focal_gap")


def members(cfg, tr, rng):
    """The benchmark's inputs: each bracket's members (period, lateral
    period, pillar rows), ascending in period, with the bracket's lateral
    period over tan(angle); and the hex cells' pillar rows."""
    brackets = gen.round_brackets(cfg, tr["perturb_m"], rng)
    for b in brackets:
        b["members"].sort(key=lambda m: m[0])
    sep = cfg["hex_sep"]
    hexes = []
    for diam in np.linspace(100.01e-9, sep - 100.01e-9, cfg["hex_entries"]):
        r = diam / 2
        hexes.append(np.array([[0.0, 0.0, r, r, 0.0],
                               [sep * math.sqrt(3) / 2, sep / 2, r, r, 0.0]]))
    return {"brackets": brackets, "hex": hexes, "hex_sep": sep,
            "hex_period": sep * math.sqrt(3)}


def _quiet():
    return contextlib.redirect_stdout(io.StringIO())


def setup(cell, seed, device):
    import importlib
    from metalens_tpu_torch import Grating, GratingCollection, HexGridSet
    from metalens_tpu_torch.assembly import make_design
    nearfield = importlib.import_module("metalens_tpu_torch.nearfield")
    farfield = importlib.import_module("metalens_tpu_torch.farfield")
    cfg, tr = cell.config, cell.traffic
    lam = tr["wavelength"]
    rng = gen.rng(seed)
    geo = members(cfg, tr, rng)
    ng, nt = index(cfg["n_glass"], lam), index(cfg["n_tio2"], lam)
    h = cfg["cyl_height"]

    def grating(gp, ly, rows):
        g = Grating(lateral_period=ly, cyl_height=h, grating_period=gp,
                    n_glass=ng, n_tio2=nt)
        g.xyrra_list = np.array(rows, copy=True)
        return g
    gcs = [GratingCollection(
        target_wavelength=cfg["design_wavelength"],
        lateral_period=b["lp_over_tan"], lens_type="round",
        grating_list=[grating(*m) for m in b["members"]])
        for b in geo["brackets"]]
    hgs = HexGridSet(sep=geo["hex_sep"], cyl_height=h, n_glass=ng,
                     n_tio2=nt, grating_list=[
                         grating(geo["hex_period"], geo["hex_sep"], rows)
                         for rows in geo["hex"]])
    numG, steps = cfg["characterize_numG"], cfg["u_steps"]
    with _quiet():
        for gc in gcs:
            gc.characterize(lam, numG=numG, u_steps=steps, device=device)
        hgs.characterize(wavelength=lam, numG=numG, just_normal=False,
                         u_steps=steps, device=device)
        for obj in (*gcs, hgs):
            obj.build_interpolators(device=device)
    deg = math.pi / 180
    half = tr["aperture_scale"] * cfg["radius"]
    state = {"cfg": cfg, "tr": tr, "geo": geo, "gcs": gcs, "hgs": hgs,
             "collections": [[(lo * deg, hi * deg), gc] for (lo, hi), gc
                             in zip(cfg["brackets_deg"], gcs)],
             "pts": np.linspace(-half, half, tr["aperture_pts"]),
             "lam": lam, "n_glass": ng, "device": device, "done": 0,
             "make_design": make_design, "nf": nearfield, "ff": farfield,
             "chk": cell.workload["check"],
             "kept": gen.Reservoir(rng, 1)}
    run_unit(state, _no_spans)          # every shape of the check, warm
    state["done"] = 0
    state["kept"] = gen.Reservoir(rng, 1)
    return state


@contextlib.contextmanager
def _no_spans(name):
    yield


def run_unit(state, spans):
    cfg, tr, pts, lam = state["cfg"], state["tr"], state["pts"], state["lam"]
    d, dev = cfg["source_distance"], state["device"]
    with spans("make_design"):
        lps, lcs, r_sw, xyrra = state["make_design"](
            state["collections"], d, cfg["radius"], state["hgs"],
            make_xyrra_list=True, wavelength=lam)
    with spans("build_nearfield"):
        out = state["nf"].build_nearfield(
            0.0, 0.0, -d, "x", lam, lps, lcs, state["hgs"], pts, pts,
            dipole_moment=tr["dipole_moment"], device=dev)
    with spans("farfield"):
        far = state["ff"].farfield(*out[:4], pts, pts, lam, out[7],
                                   device=dev)
        P, total, ux, uy, dux, duy = far
        m = state["ff"].focal_metrics(P, ux, uy, dux, duy, total, out[6],
                                      spot_radius_u=tr["spot_u"])
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    state["kept"].offer({"lps": lps, "lcs": lcs, "xyrra": xyrra,
                         "fields": out[:4], "power": out[6], "P": P,
                         "total": total, "metrics": m})
    state["done"] += 1


def end_to_end(state, units, window_s):
    return {"lens_check_s": window_s / units}


def trace_units(state):
    return state["tr"]["trace_units"]


def release(state):
    for obj in (*state["gcs"], state["hgs"]):
        obj.interpolators = None
    state["make_design"] = state["nf"] = state["ff"] = None


# ----- the check -----

def _db(g):
    return {(rl.key(e["ux"]), rl.key(e["uy"]), e["ox"], e["oy"],
             e["x_or_y"]): (e["ampfy"], e["ampfx"]) for e in g.data}


def program_view(state):
    """The kept check and the databases in the reference's terms."""
    k = state["kept"].items[0]
    sep = state["geo"]["hex_sep"]
    lps = k["lps"]
    lcs = np.asarray(k["lcs"]).reshape(-1, 3)
    n2 = np.round(2 * lcs[:, 0] / (sep * math.sqrt(3))).astype(int)
    n1 = np.round(lcs[:, 1] / sep - n2 / 2).astype(int)
    return {"dbs": [[_db(g) for g in gc.grating_list]
                    for gc in state["gcs"]],
            "hex_dbs": [_db(g) for g in state["hgs"].grating_list],
            "rings": {"r_min": lps["r_min_list"], "r_max": lps["r_max_list"],
                      "r_center": lps["r_center_list"],
                      "period": lps["grating_period_list"],
                      "bracket": lps["gratingcollection_index_here_list"],
                      "copies": lps["num_around_circle_list"]},
            "site_keys": np.stack([n1, n2], 1), "site_xy": lcs[:, :2],
            "picks": lcs[:, 2].astype(int),
            "centre_pillars": k["xyrra"][:len(lcs)],
            "periphery_pillars": k["xyrra"][len(lcs):],
            "fields": k["fields"], "P": k["P"],
            "metrics": {"transmission": k["metrics"]["transmission"],
                        "spot_fraction":
                            k["metrics"]["spot_fraction_of_total"]}}


def databases(state, prec=ref.FULL, dtype=torch.float64):
    """The reference's databases of every member, as the program's sweeps
    run them: (bracket databases, hex databases)."""
    cfg, lam, geo = state["cfg"], state["lam"], state["geo"]
    ng, nt = state["n_glass"], index(cfg["n_tio2"], lam)
    numG, steps = cfg["characterize_numG"], cfg["u_steps"]
    kw = dict(nv=cfg["nv"], prec=prec, dtype=dtype, device=state["device"])
    wl = cfg["design_wavelength"]
    out = []
    for b in geo["brackets"]:
        ms = b["members"]
        ux, uy = rl.grid_directions(
            max(-0.99, math.asin(wl / ms[-1][0]) - 0.25),
            min(0.99, math.asin(wl / ms[0][0]) + 0.25), -0.2, 0.2, steps)
        out.append([rl.member_database(rows, gp, ly, cfg["cyl_height"],
                                       nt ** 2, ng ** 2, lam, ux, uy, numG,
                                       **kw) for gp, ly, rows in ms])
    ux, uy = rl.grid_directions(-0.499, 0.501, -0.499, 0.501, 2 * steps - 1)
    hexes = [rl.member_database(rows, geo["hex_period"], geo["hex_sep"],
                                cfg["cyl_height"], nt ** 2, ng ** 2, lam, ux,
                                uy, numG, **kw) for rows in geo["hex"]]
    return out, hexes


def layout(state, hex_dbs):
    """The reference's rings, and its centre sites (lattice keys and
    positions) with each member's score there."""
    cfg, geo, lam = state["cfg"], state["geo"], state["lam"]
    deg = math.pi / 180
    d = cfg["source_distance"]
    ring = rl.rings([(lo * deg, hi * deg) for lo, hi in cfg["brackets_deg"]],
                    [b["lp_over_tan"] for b in geo["brackets"]], d,
                    cfg["radius"], lam)
    keys, xy = rl.hex_sites(geo["hex_sep"], ring["r_min"][0] - 300e-9)
    k0 = rl.key(0.001)
    x_amp = [db[(k0, k0, 0, 0, "x")][1] for db in hex_dbs]
    return ring, keys, xy, rl.site_scores(xy, x_amp, d, lam)


def pillars(state, ring, xy, picks):
    """The reference's centre pillars (one a site) and periphery pillars."""
    geo = state["geo"]
    radius = np.array([rows[0, 2] for rows in geo["hex"]])[picks]
    centre = np.stack([xy[:, 0], xy[:, 1], radius, radius,
                       np.zeros(len(xy))], 1)
    periods = [np.array([m[0] for m in b["members"]])
               for b in geo["brackets"]]
    rows = [np.stack([m[2] for m in b["members"]]) for b in geo["brackets"]]
    return centre, rl.periphery_pillars(ring, periods, rows)


def stitch(state, dbs, hex_dbs, ring, keys, xy, picks, cdt, rnd=rl.exact):
    """The reference's near field of the lens laid out with ``picks`` at
    the centre sites, from the databases ``dbs`` and ``hex_dbs``."""
    cfg, tr, geo = state["cfg"], state["tr"], state["geo"]
    dev = state["device"]
    tables = [rl.Table(*rl.tabulate(bd, [m[0] for m in b["members"]]), dev,
                       cdt) for bd, b in zip(dbs, geo["brackets"])]
    hex_table = rl.Table(*rl.tabulate(hex_dbs), dev, cdt)
    return rl.near_field(
        state["pts"], state["lam"], cfg["source_distance"], state["n_glass"],
        ring, tables, keys, xy, picks, hex_table,
        (geo["hex_period"], geo["hex_sep"]), tr["dipole_moment"], cdt=cdt,
        device=dev, rnd=rnd)


def far(state, F, power):
    P, ok, total, us, du = rl.far_field(F, state["pts"], state["lam"],
                                        state["n_glass"])
    m = rl.focal(P, total, us, du, power, state["tr"]["spot_u"])
    return P, ok, {k: m[k] for k in ("transmission", "spot_fraction")}


def _ring_misses(got, want, tol=1e-12):
    n = len(want["r_min"])
    if len(got["r_min"]) != n:
        return max(n, len(got["r_min"]))
    bad = np.zeros(n, dtype=bool)
    for k in ("r_min", "r_max", "r_center", "period"):
        g, w = np.asarray(got[k], float), np.asarray(want[k], float)
        bad |= np.abs(g - w) > tol * np.abs(w)
    for k in ("bracket", "copies"):
        bad |= np.asarray(got[k]) != np.asarray(want[k])
    return int(bad.sum())


def _row_misses(got, want, tol_m=1e-15, tol_rad=1e-12):
    """Pillar rows (x, y, rx, ry, angle) that differ beyond rounding."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    if got.shape != want.shape:
        return max(len(got), len(want))
    d = np.abs(got - want)
    return int(((d[:, :4] > tol_m).any(1) | (d[:, 4] > tol_rad)).sum())


def _field_gap(got, want):
    """The widest gap of each field as a share of its largest value, the
    largest over the fields."""
    gap = 0.0
    for g, w in zip(got, want):
        r = (g.to(w.device, w.dtype) - w).abs().max() / w.abs().max()
        gap = max(gap, float(r.nan_to_num(nan=float("inf"))))
    return gap


def readings(state, view, truth, limits):
    """The compared numbers of a view (the program's or the control's)
    against the reference's ``truth`` (its databases and layout)."""
    ref_dbs, ref_hex, ring, keys, xy, S = truth
    gaps = [rl.database_gap(g, w) for gs, ws in
            zip(view["dbs"], ref_dbs) for g, w in zip(gs, ws)] \
        + [rl.database_gap(g, w) for g, w in zip(view["hex_dbs"], ref_hex)]
    if len(view["dbs"]) != len(ref_dbs):
        gaps.append(float("inf"))
    # the centre: the view's sites matched to the reference's by lattice key
    at = {tuple(q): i for i, q in enumerate(view["site_keys"].tolist())}
    rows = np.array([at.get(tuple(q), -1) for q in keys.tolist()])
    miss = _ring_misses(view["rings"], ring) \
        + int((rows < 0).sum()) + len(at) - int((rows >= 0).sum())
    best = S.argmax(1)
    mine = np.where(rows >= 0, view["picks"][rows], best)
    loss = S[np.arange(len(S)), best] - S[np.arange(len(S)), mine]
    picks = np.where(loss <= limits["pick_loss"]["max"], mine, best)
    centre, periphery = pillars(state, ring, xy, picks)
    ok = rows >= 0
    miss += int((np.abs(view["site_xy"][rows[ok]] - xy[ok]) > 1e-15)
                .any(1).sum()) \
        + _row_misses(view["centre_pillars"][rows[ok]], centre[ok]) \
        + _row_misses(view["periphery_pillars"], periphery)
    # the stitch by itself: from the view's own databases and layout
    own, _ = stitch(state, view["dbs"], view["hex_dbs"], ring,
                    view["site_keys"], view["site_xy"], view["picks"],
                    torch.complex128)
    stitch_err = _field_gap(view["fields"], own)
    del own
    # end to end: the reference's lens from its own databases
    F, power = stitch(state, ref_dbs, ref_hex, ring, keys, xy, picks,
                      torch.complex128)
    P, okP, m = far(state, F, power)
    del F
    dP = torch.where(okP, (torch.as_tensor(view["P"]).to(P.device, P.dtype)
                           - P).abs(), 0.0)
    focal = max(abs(view["metrics"][k] - m[k]) for k in m)
    values = {"db_err": max(gaps), "db_med_err": float(np.median(gaps)),
              "pick_loss": float(loss.max()) if len(loss) else 0.0,
              "layout_miss": float(miss), "stitch_err": stitch_err,
              "ff_err": float(dP.max().nan_to_num(nan=float("inf"))
                              / P.max()),
              "focal_gap": focal if focal == focal else float("inf")}
    return [{"name": n, "value": values[n]} for n in NUMBERS]


def truth(state):
    ref_dbs, ref_hex = databases(state)
    return (ref_dbs, ref_hex, *layout(state, ref_hex))


def check(state):
    lim = state["chk"]["limits"]
    checks = readings(state, program_view(state), truth(state), lim)
    for c in checks:
        c.update(lim[c["name"]])
    return checks, state["done"], int(not all(map(passed, checks)))


def control(state):
    """The control: the reference in the program's place one precision
    step below complex64 -- databases with TF32 operands in every product,
    the stitch with bfloat16 operands, the far field of its fields in
    complex64, the centre members its own picks -- held to the same
    check."""
    lim = state["chk"]["limits"]
    t = truth(state)
    ring, keys, xy = t[2:5]
    low_dbs, low_hex = databases(state, prec=ref.Precision("tf32"),
                                 dtype=torch.float32)
    picks = layout(state, low_hex)[3].argmax(1)
    centre, periphery = pillars(state, ring, xy, picks)
    F, power = stitch(state, low_dbs, low_hex, ring, keys, xy, picks,
                      torch.complex64, rnd=rl.bf16)
    P, _, m = far(state, F, power)
    view = {"dbs": low_dbs, "hex_dbs": low_hex, "rings": ring,
            "site_keys": keys, "site_xy": xy, "picks": picks,
            "centre_pillars": centre, "periphery_pillars": periphery,
            "fields": F, "P": P, "metrics": m}
    return readings(state, view, t, lim)
