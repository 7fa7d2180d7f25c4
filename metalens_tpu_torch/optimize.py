"""Unit-cell optimizers on the port's engine.

Counterpart of ``metalens_tpu/optimize.py``:

* :func:`optimize` -- cyclic coordinate descent with the reference's steps
  and acceptance rule (``grating.py:685-745``);
* :func:`optimize2` -- random simultaneous perturbation
  (``grating.py:747-795``);
* :func:`optimize_gradient` -- Adam through the solver's exact shape
  derivatives (:func:`metalens_tpu_torch.engine.fom_value_and_grad`), with
  the validate() constraints as differentiable penalties;
* :func:`vary_angle` -- the continuation over deflection angle that builds
  a :class:`GratingCollection`.

The derivative-free optimizers evaluate their candidates in batches
(:class:`_BatchedProbe`); the acceptance ratchet runs on the host.  Every
entry point takes ``device=`` (default ``"cuda"``; it raises where torch
has no CUDA device, and ``device="cpu"`` asks for the plain PyTorch
versions) and ``dtype=`` (the complex working dtype) and passes them down.
New records print as spec-roundtrip ``repr`` strings (the reference's
persistence mechanism, ``grating.py:739-741``).
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from .engine import (_device, fom_batch_fn, fom_of_grating,
                     fom_value_and_grad, static_envelope)
from .grating import (GratingCollection, min_diameter, min_distance,
                      resize, validate)
from .solver import cpx
from .solver.fom import DEFAULT_FOM_TERMS
from .units import degree, inf, nm, pi

# probe batches evaluated since the last reset (chip_smoke.py reads and
# resets it)
probe_batches = 0


# --------------------------------------------------------------------------
# derivative-free optimizers
# --------------------------------------------------------------------------

class _BatchedProbe:
    """Every candidate FOM of a derivative-free optimize run, evaluated B
    at a time by one batched solve (:func:`fom_batch_fn`).  Short candidate
    lists are padded by repetition, so every batch has the same shape."""

    def __init__(self, g, target_wavelength, numG, terms, B,
                 static_override=None, *, device="cuda", dtype=None):
        self.B = B
        self._fn = fom_batch_fn(g, target_wavelength=target_wavelength,
                                numG=numG, terms=terms,
                                static_override=static_override,
                                device=device, dtype=dtype)

    def __call__(self, candidates):
        global probe_batches
        candidates = list(candidates)
        assert candidates
        out = []
        for i in range(0, len(candidates), self.B):
            chunk = candidates[i:i + self.B]
            batch = np.stack(chunk + [chunk[-1]] * (self.B - len(chunk)))
            out.append(self._fn(batch)[:len(chunk)].cpu().numpy())
            probe_batches += 1
        return np.concatenate(out)


def _ratchet_walk(g, direction, fom_now, probe, similar_to, how_similar,
                  verbose, loud_validate=False, max_steps=10):
    """Walk ``g.xyrra_list`` along ``direction``, keeping each step while
    the geometry stays feasible and the FOM does not drop (ties advance --
    the reference's acceptance rule); at most ``max_steps`` steps.  The
    walk's candidates are evaluated in one batch up front (exact, since
    standardize() changes neither the FOM nor validate()).  Returns (fom
    after the walk, whether any step stuck)."""
    start = g.xyrra_list.copy()
    scratch = g.copy()
    cands = []
    for k in range(1, max_steps + 1):
        scratch.xyrra_list = start + k * direction
        if not validate(scratch, similar_to=similar_to,
                        how_similar=how_similar):
            break
        cands.append(start + k * direction)
    if not cands:
        return fom_now, False
    foms = probe(cands)
    kept = 0
    for k, fom_stepped in enumerate(foms, start=1):
        if fom_stepped < fom_now:
            break
        fom_now = fom_stepped
        kept = k
    for k in range(1, kept + 1):
        g.xyrra_list[...] = start + k * direction
        g.standardize()
        assert validate(g, similar_to=similar_to, how_similar=how_similar,
                        print_details=loud_validate)
        if verbose:
            print("#New record! ", foms[k - 1])
            print("mygrating=" + repr(g), flush=True)
            print("", flush=True)
    return fom_now, kept > 0


def _probe_batch_size(g):
    """One batch size serves optimize()'s first steps (2*nE*5), the
    ratchet walks (10) and optimize2's attempt chunks."""
    return max(16, 2 * g.xyrra_list.size)


def optimize(mygrating_start, target_wavelength, similar_to=None,
             how_similar=None, subfolder=None, numG=50, terms=None,
             verbose=True, rng=None, static_override=None, *,
             device="cuda", dtype=None):
    """Cyclic coordinate descent: shuffled sweeps over every (ellipse,
    parameter) coordinate, ratcheting each by +-1 nm (+-0.3 deg for the
    rotation) while the FOM holds or improves, until a full sweep makes no
    progress (reference ``grating.py:685-745``).  The first steps of all
    2*nE*5 directions are evaluated in one batch per geometry change.
    ``subfolder`` is accepted for API parity and ignored; ``rng``: optional
    numpy Generator for the sweep shuffle (None: the stdlib global RNG)."""
    assert validate(mygrating_start, print_details=True,
                    similar_to=similar_to, how_similar=how_similar)
    g = mygrating_start.copy()
    probe = _BatchedProbe(g, target_wavelength, numG, terms,
                          _probe_batch_size(g),
                          static_override=static_override, device=device,
                          dtype=dtype)

    fom_now = probe([g.xyrra_list])[0]
    if verbose:
        print("fom now...", fom_now, flush=True)
    n_ell, n_par = g.xyrra_list.shape
    coords = [(e, p) for e in range(n_ell) for p in range(n_par)]

    def all_directions():
        dirs = {}
        for e, p in coords:
            size = 0.3 * degree if p == 4 else 1 * nm
            for signed in (-size, size):
                d = np.zeros_like(g.xyrra_list)
                d[e, p] = signed
                dirs[(e, p, signed > 0)] = d
        return dirs

    scratch = g.copy()
    stalled = False
    first_step_fom = None   # invalidated whenever the geometry moves
    while not stalled:
        if rng is None:
            random.shuffle(coords)
        else:
            rng.shuffle(coords)
        stalled = True
        for e, p in coords:
            size = 0.3 * degree if p == 4 else 1 * nm
            for signed in (-size, size):
                if first_step_fom is None:
                    dirs = all_directions()
                    keys = list(dirs)
                    vals = probe([g.xyrra_list + dirs[k] for k in keys])
                    first_step_fom = dict(zip(keys, vals))
                direction = dirs[(e, p, signed > 0)]
                # the walk's first step, screened against the cache
                scratch.xyrra_list = g.xyrra_list + direction
                if not validate(scratch, similar_to=similar_to,
                                how_similar=how_similar):
                    continue
                if first_step_fom[(e, p, signed > 0)] < fom_now:
                    continue
                fom_now, moved = _ratchet_walk(
                    g, direction, fom_now, probe, similar_to,
                    how_similar, verbose)
                if moved:
                    stalled = False
                    first_step_fom = None
                    break    # this direction won; don't probe its opposite
    return g


def optimize2(mygrating_start, target_wavelength, attempts=inf,
              similar_to=None, how_similar=None, subfolder=None, numG=50,
              terms=None, verbose=True, rng=None, static_override=None, *,
              device="cuda", dtype=None):
    """Random simultaneous perturbation: each attempt draws one uniform
    step for all coordinates at once (per-coordinate ceiling 1 nm / 0.1 deg,
    divided by the coordinate count) and ratchets along it (reference
    ``grating.py:747-795``).  Directions are drawn in chunks, in the serial
    loop's draw order, and their first steps screened in one batch; a chunk
    whose geometry went stale after a win is screened again."""
    assert validate(mygrating_start, print_details=True,
                    similar_to=similar_to, how_similar=how_similar)
    rng = rng or np.random
    g = mygrating_start.copy()
    probe = _BatchedProbe(g, target_wavelength, numG, terms,
                          _probe_batch_size(g),
                          static_override=static_override, device=device,
                          dtype=dtype)

    fom_now = probe([g.xyrra_list])[0]
    if verbose:
        print("fom now...", fom_now, flush=True)
    step_ceiling = np.empty_like(g.xyrra_list)
    step_ceiling[:, 0:4] = 1 * nm
    step_ceiling[:, 4] = 0.1 * degree
    step_ceiling /= g.xyrra_list.size

    scratch = g.copy()
    tried = 0
    pending = []          # drawn-ahead directions, consumed in draw order
    pending_fom = []      # their first-step FOMs from the current geometry
    while tried < attempts:
        if not pending:
            n_draw = probe.B
            if attempts != inf:
                n_draw = min(n_draw, int(attempts) - tried)
            pending = [step_ceiling
                       * (2 * rng.random(size=step_ceiling.shape) - 1)
                       for _ in range(n_draw)]
            pending_fom = []
        if not pending_fom:
            pending_fom = list(probe([g.xyrra_list + d for d in pending]))
        direction = pending.pop(0)
        first_fom = pending_fom.pop(0)
        tried += 1
        scratch.xyrra_list = g.xyrra_list + direction
        if not validate(scratch, similar_to=similar_to,
                        how_similar=how_similar):
            continue
        if first_fom < fom_now:
            continue
        fom_now, moved = _ratchet_walk(g, direction, fom_now, probe,
                                       similar_to, how_similar, verbose,
                                       loud_validate=True)
        if moved:
            pending_fom = []     # geometry moved: re-screen the chunk
    return g


# --------------------------------------------------------------------------
# differentiable constraints + gradient optimizer
# --------------------------------------------------------------------------

def constraint_penalty(xyrra, grating_period, lateral_period,
                       min_radius, min_gap, similar_to=None,
                       how_similar=None, num_points: int = 48,
                       sharpness: float = 4.0):
    """Smooth penalty version of :func:`validate` for an (nE, 5) tensor:
    zero on (strictly) feasible geometry, growing quadratically outside.
    Differentiable; the same-pillar distances are masked to inf before the
    square root, so no NaN reaches the gradient."""
    x0, y0 = xyrra[:, 0], xyrra[:, 1]
    rx, ry, ang = xyrra[:, 2], xyrra[:, 3], xyrra[:, 4]
    pen = (torch.relu(min_radius - rx) ** 2
           + torch.relu(min_radius - ry) ** 2).sum() / min_radius ** 2

    theta = torch.as_tensor(
        np.linspace(0.0, 2 * pi, num_points, endpoint=False),
        dtype=xyrra.dtype, device=xyrra.device)
    dx0 = rx[:, None] * torch.cos(theta)
    dy0 = ry[:, None] * torch.sin(theta)
    ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    px = x0[:, None] + dx0 * ca - dy0 * sa        # (nE, P)
    py = y0[:, None] + dx0 * sa + dy0 * ca

    nE = xyrra.shape[0]
    fx = px.reshape(-1)
    fy = py.reshape(-1)
    dx = torch.remainder(fx[:, None] - fx[None, :], grating_period)
    dx = torch.minimum(dx, grating_period - dx)
    dy = torch.remainder(fy[:, None] - fy[None, :], lateral_period)
    dy = torch.minimum(dy, lateral_period - dy)
    d2 = dx * dx + dy * dy
    eid = torch.arange(nE, device=xyrra.device).repeat_interleave(num_points)
    same = eid[:, None] == eid[None, :]
    d2 = torch.where(same, inf, d2)
    viol = torch.relu(min_gap - torch.sqrt(d2 + 1e-30))
    pen = pen + (viol ** 2).sum() / min_gap ** 2

    # self vs own y-replica
    d2s = (px[:, :, None] - px[:, None, :]) ** 2 + \
          (py[:, :, None] - (py[:, None, :] + lateral_period)) ** 2
    viol_s = torch.relu(min_gap - torch.sqrt(d2s + 1e-30))
    pen = pen + (viol_s ** 2).sum() / min_gap ** 2

    if similar_to is not None:
        sim = torch.as_tensor(similar_to, dtype=xyrra.dtype,
                              device=xyrra.device)
        rel_r = torch.abs(xyrra[:, 2:4] - sim[:, 2:4]) / sim[:, 2:4]
        pen = pen + (torch.relu(rel_r - how_similar) ** 2).sum() \
            / how_similar ** 2
        for col, period in ((0, grating_period), (1, lateral_period),
                            (4, 2 * pi)):
            d = torch.remainder(xyrra[:, col] - sim[:, col], period)
            d = torch.minimum(d, period - d)
            pen = pen + (torch.relu(d / period - how_similar) ** 2).sum() \
                / how_similar ** 2
    return sharpness * pen


class _Adam:
    """optax.adam's update, written out: b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0, bias-corrected moments, the step -lr * m_hat /
    (sqrt(v_hat) + eps).  (``torch.optim.Adam`` cannot take the per-column
    scale that :func:`optimize_gradient` applies after the step.)"""

    def __init__(self, learning_rate, like, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def update(self, g):
        self.count += 1
        self.mu = (1 - self.b1) * g + self.b1 * self.mu
        self.nu = (1 - self.b2) * (g * g) + self.b2 * self.nu
        mu_hat = self.mu / (1 - self.b1 ** self.count)
        nu_hat = self.nu / (1 - self.b2 ** self.count)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps) * -self.lr


def optimize_gradient(mygrating_start, target_wavelength, steps: int = 120,
                      learning_rate=None, similar_to=None, how_similar=None,
                      numG=50, terms=None, penalty_weight: float = 30.0,
                      verbose=True, seed: int = 0, *, device="cuda",
                      dtype=None):
    """Gradient ascent on the FOM through the solver's shape derivatives
    (Adam + differentiable constraint penalties + trust region).  Each step
    is one :func:`fom_value_and_grad` call, which also scores the previous
    update's iterate.  Returns the best iterate that passes the exact
    :func:`validate`.  ``seed`` is accepted for API parity (the path draws
    nothing)."""
    device = _device(device)
    rdt = cpx.real_dtype(cpx.complex_dtype(device, dtype))
    assert validate(mygrating_start, print_details=True,
                    similar_to=similar_to, how_similar=how_similar)
    g = mygrating_start.copy()
    vg = fom_value_and_grad(g, target_wavelength=target_wavelength,
                            numG=numG, terms=terms, device=device,
                            dtype=dtype)
    Lx, Ly = g.grating_period, g.lateral_period

    def loss_and_grad(xyrra):
        fom, dfom = vg(xyrra)
        x = xyrra.detach().clone().requires_grad_(True)
        pen = constraint_penalty(x, Lx, Ly, min_diameter / 2, min_distance,
                                 similar_to, how_similar)
        dpen, = torch.autograd.grad(pen, x)
        # ascend the FOM, descend the penalty
        return fom, pen.detach(), dfom - penalty_weight * dpen

    if learning_rate is None:
        # Adam's normalization makes the step the unit of motion: ~0.5 nm
        # per step for lengths, ~0.03 deg for the rotation (below)
        learning_rate = 0.5 * nm
    x = torch.as_tensor(g.xyrra_list, dtype=rdt).to(device)
    scale = torch.ones_like(x)
    scale[:, 4] = (0.03 * degree) / (0.5 * nm)
    opt = _Adam(learning_rate, x)

    best_fom = fom_of_grating(g, target_wavelength=target_wavelength,
                              numG=numG, terms=terms, device=device,
                              dtype=dtype)
    best_xyrra = np.array(g.xyrra_list, copy=True)

    def consider(xyrra, fom_at_x, pen, step):
        # keep the best iterate that passes the exact validate(), on the host
        nonlocal best_fom, best_xyrra
        g.xyrra_list = xyrra.detach().cpu().numpy().astype(np.float64)
        if validate(g, similar_to=similar_to, how_similar=how_similar):
            f_new = float(fom_at_x)
            if f_new > best_fom:
                best_fom = f_new
                best_xyrra = g.xyrra_list.copy()
                if verbose:
                    print(f"#step {step}: fom={best_fom:.6f} "
                          f"pen={float(pen):.3g}")

    for step in range(steps):
        fom, pen, grad_total = loss_and_grad(x)
        if step > 0:     # step 0 is the start geometry, already in best
            consider(x, fom, pen, step)
        x = x + opt.update(-grad_total) * scale
    # the final update's iterate has not been scored yet
    consider(x, vg(x)[0], 0.0, steps)
    g.xyrra_list = best_xyrra
    g.standardize()
    assert validate(g, similar_to=similar_to, how_similar=how_similar)
    if verbose:
        print("best fom:", best_fom)
        print("mygrating=" + repr(g), flush=True)
    return g


# --------------------------------------------------------------------------
# continuation over deflection angle
# --------------------------------------------------------------------------

def _continuation_ladder(all_gratings, end_angle, change_each_step):
    """The ``(grating_period, lateral_period)`` of every member a
    :func:`vary_angle` continuation visits, from the newest member on,
    without optimizing anything (the same ``get_one`` period arithmetic)."""
    cyl = all_gratings.lens_type == "cyl"
    prev = all_gratings.grating_list[-1 if cyl else 0]
    pairs = [(prev.grating_period, prev.lateral_period)]
    lam = all_gratings.target_wavelength
    gp, lp = prev.grating_period, prev.lateral_period
    while True:
        if cyl:
            g = all_gratings.get_one(grating_period=gp * change_each_step)
        else:
            g = all_gratings.get_one(lateral_period=lp * change_each_step)
        a = g.get_angle_in_air(target_wavelength=lam)
        if (cyl and a < end_angle) or (not cyl and a > end_angle):
            break
        pairs.append((g.grating_period, g.lateral_period))
        gp, lp = g.grating_period, g.lateral_period
    return pairs


def continuation_static_envelope(start_grating, end_angle, lens_type,
                                 target_wavelength, numG=50, terms=None,
                                 change_each_step=1.01, *, device="cuda",
                                 dtype=None):
    """The ``(Dx, Dy, n_slabs, taylor_terms)`` envelope covering every
    member of a :func:`vary_angle` continuation (the start included), for
    ``static_override``; the slab cap follows the working dtype of
    ``device`` and ``dtype``."""
    cdt = cpx.complex_dtype(_device(device), dtype)
    gc = _init_collection(start_grating, lens_type, target_wavelength)
    pairs = _continuation_ladder(gc, end_angle, change_each_step)
    tt = tuple(terms) if terms is not None else DEFAULT_FOM_TERMS
    return static_envelope(start_grating, pairs,
                           [t.wavelength for t in tt], numG, dtype=cdt)


def _init_collection(start_grating, lens_type, target_wavelength):
    if lens_type == "cyl":
        return GratingCollection(
            target_wavelength=target_wavelength,
            lateral_period=start_grating.lateral_period,
            grating_list=[start_grating], lens_type="cyl")
    assert lens_type == "round"
    angle_in_air = start_grating.get_angle_in_air(
        target_wavelength=target_wavelength)
    lateral_period = start_grating.lateral_period / math.tan(angle_in_air)
    return GratingCollection(
        target_wavelength=target_wavelength,
        lateral_period=lateral_period,
        grating_list=[start_grating], lens_type="round")


def vary_angle(start_grating=None, end_angle=None, lens_type=None,
               target_wavelength=None, start_grating_collection=None,
               subfolder=None, numG=50, terms=None, use_gradient=False,
               optimize2_attempts=200, gradient_steps=120, verbose=True,
               change_each_step=1.01, similarity_each_step=0.03, rng=None,
               use_fused=False, static_override=None, min_gap=None, *,
               device="cuda", dtype=None):
    """Geometric continuation building a GratingCollection (reference
    ``grating.py:820-918``): step the period by ``change_each_step`` per
    member, seed each member from the previous one by :func:`resize`,
    optimize it under the ``similarity_each_step`` trust region, until
    ``end_angle`` is crossed.  The inner loop is :func:`optimize` then
    :func:`optimize2` (derivative-free, the default), or with
    ``use_gradient=True`` :func:`optimize_gradient` then :func:`optimize2`.
    ``rng``: optional numpy Generator threaded into every inner call.
    ``use_fused`` (the on-device ratchet loop) and its ``min_gap`` are not
    ported yet (ROADMAP.md)."""
    if use_fused:
        raise NotImplementedError(
            "use_fused=True needs optimize_fused, which the port does not "
            "have yet (ROADMAP.md, 'What is left')")
    device = _device(device)
    if start_grating_collection is None:
        if start_grating is None or target_wavelength is None:
            raise ValueError(
                "provide BOTH start_grating and target_wavelength, or a "
                "start_grating_collection")
    elif start_grating is not None or target_wavelength is not None:
        raise ValueError(
            "start_grating_collection is exclusive of start_grating/"
            "target_wavelength (the collection carries its own)")

    if start_grating_collection is not None:
        all_gratings = start_grating_collection
    else:
        all_gratings = _init_collection(start_grating, lens_type,
                                        target_wavelength)

    assert change_each_step > 1 and similarity_each_step > 0

    while True:
        if verbose:
            print("grating collection so far:")
            print(repr(all_gratings))

        if all_gratings.lens_type == "cyl":
            grating_prev = all_gratings.grating_list[-1]
            grating_new_start = all_gratings.get_one(
                grating_period=grating_prev.grating_period * change_each_step)
        else:
            grating_prev = all_gratings.grating_list[0]
            grating_new_start = all_gratings.get_one(
                lateral_period=grating_prev.lateral_period * change_each_step)
        angle_in_air = grating_new_start.get_angle_in_air(
            target_wavelength=all_gratings.target_wavelength)
        if angle_in_air < end_angle and all_gratings.lens_type == "cyl":
            break
        if angle_in_air > end_angle and all_gratings.lens_type == "round":
            break

        if verbose:
            print("Optimizing for angle_in_air = ", angle_in_air / degree,
                  "degree")
        grating_new_start = resize(grating_prev, grating_new_start)
        # every inner call: the 3% trust region around the resized seed
        common = dict(target_wavelength=all_gratings.target_wavelength,
                      similar_to=grating_new_start.xyrra_list,
                      how_similar=similarity_each_step, numG=numG,
                      terms=terms, verbose=verbose, device=device,
                      dtype=dtype)
        if use_gradient:
            grating_new = optimize_gradient(grating_new_start,
                                            steps=gradient_steps, **common)
        else:
            grating_new = optimize(grating_new_start, rng=rng,
                                   static_override=static_override, **common)
        grating_new = optimize2(
            grating_new, attempts=optimize2_attempts, rng=rng,
            static_override=None if use_gradient else static_override,
            **common)

        all_gratings.add_one(grating_new)

    return all_gratings
