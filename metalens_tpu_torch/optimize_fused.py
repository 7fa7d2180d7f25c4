"""The fused design loop on the port's engine: the derivative-free
ratchets with their accept logic on the device.

Counterpart of ``metalens_tpu/optimize_fused.py``:

* :func:`optimize_fused` -- the coordinate-descent ratchet
  (``optimize``'s semantics): each round screens all 2*nE*5 unit
  directions in one FOM batch, takes the first feasible non-decreasing one
  in shuffled order and walks it for steps 2..10 in a second batch;
  repeated until a round accepts nothing.
* :func:`optimize2_fused` -- the random simultaneous perturbation
  (``optimize2``'s semantics): each attempt evaluates the proposal and its
  walk steps 1..10 in one batch.
* :func:`optimize_multistart` -- best-of-k seeded restarts of the chain.
* :func:`feasible_traced` -- the torch twin of
  :func:`metalens_tpu_torch.grating.validate` for a batch of candidates.

The JAX module runs each loop as one XLA program (``lax.while_loop``).
PyTorch is eager, so here each loop is a host loop whose every round is a
fixed sequence of device operations: the FOM batches, the feasibility
check, the choice of direction (``argmax`` over the visit order) and the
ratchet (``torch.where``).  The host reads one value per
coordinate-descent round (``stalled``) and none per random-perturbation
attempt, whose count it knows.

Left behind as TPU workarounds: the padding of every FOM batch to
``FUSED_PROBE_BATCH`` (it shared one Mosaic compile signature; here the
screen runs at B = 2*nE*5 and the walk at B = 9, or B = 10 for the
proposal and its walk), and the ``lru_cache``d programs (eager torch
compiles nothing).  The static envelope (``static_override``) stays: it
changes Dx, Dy, n_slabs and taylor_terms, so it changes the numbers.

Semantics notes, as in the JAX module:

* Draws.  ``torch.Generator`` cannot reproduce ``jax.random``.  The
  default draw source (:class:`TorchDraws`) is a ``torch.Generator`` on the
  working device seeded by ``seed``: runs are reproducible per seed within
  the port but do not replay the JAX package's sequence.  :func:`_cd_run`
  and :func:`_rp_run` take the draw source as an argument (an object with
  ``permutation(n)`` and ``uniform(shape)``), so another sequence can be
  injected -- the JAX package's is ``key, k1 = jax.random.split(key)`` per round, then
  ``jax.random.permutation(k1, nC)`` or ``jax.random.uniform(k1, shape,
  dtype, -1, 1)``, from ``jax.random.PRNGKey(seed)``.
* Intermediate ``standardize()`` calls are elided (the walk's
  ``start + k * direction`` is exact); the result is standardized and
  re-validated on the host.
* The FOM runs with ``small_u=False`` (the full J1 branch): the host does
  not re-route candidates whose radii outgrow the small-argument headroom.
* On CUDA the feasibility check runs in float32 with ``margin=1e-5``, so a
  device accept always re-validates in float64 on the host.

Every entry point takes ``device=`` (default ``"cuda"``; it raises where
torch has no CUDA device, and ``device="cpu"`` asks for the plain PyTorch
versions of the kernels) and ``dtype=`` (the complex working dtype).
"""

from __future__ import annotations

import numpy as np
import torch

from . import trace
from .engine import (_device, _fom_eval, _fom_inputs, _order_bounds,
                     _order_tensors, apply_static_override)
from .grating import min_diameter, min_distance, validate
from .solver import cpx
from .units import degree, nm, pi


# --------------------------------------------------------------------------
# exact on-device validate()
# --------------------------------------------------------------------------

@trace.traced("fused.feasible")
def feasible_traced(xyrra, Lx, Ly, min_r, min_gap, sim=None,
                    how_similar=None, num_points: int = 100,
                    margin: float = 0.0):
    """Torch twin of :func:`metalens_tpu_torch.grating.validate` for a batch
    ``xyrra`` (..., nE, 5) -> bool tensor (...): True iff every semi-axis
    >= ``min_r``, every pillar-pillar and pillar-self-replica outline
    distance >= ``min_gap`` (periodic metric, ``num_points`` outline
    samples -- validate uses 100), and, when ``sim`` is given, the
    trust-region drift bounds hold.  The thresholds are the host's exact
    complements (the host rejects on strict ``<`` / ``>``).

    ``margin`` tightens every threshold by that relative amount.  The fused
    optimizers pass 1e-5: the 1-nm / 0.3-deg steps are sometimes exactly
    commensurate with a bound (24 x 0.3 deg is the 2% x 360 deg trust
    radius), and there a float32 accept on the card could flip against the
    host's final float64 ``validate()``.  1e-5 is about 100x the float32
    evaluation error, so device accepts always re-validate on the host,
    while only the single boundary-exact step of a quantized walk is
    excluded."""
    x = torch.as_tensor(xyrra)
    nE = x.shape[-2]
    lo = 1.0 + margin       # floors rise
    hi = 1.0 - margin       # drift ceilings shrink
    ok = x[..., 2:4].amin((-2, -1)) >= min_r * lo

    # jnp.linspace(0, 2 pi, n, endpoint=False)'s arithmetic
    theta = (torch.arange(num_points, dtype=x.dtype, device=x.device)
             / num_points) * (2 * pi)
    dx0 = x[..., 2, None] * torch.cos(theta)
    dy0 = x[..., 3, None] * torch.sin(theta)
    ca = torch.cos(x[..., 4])[..., None]
    sa = torch.sin(x[..., 4])[..., None]
    px = x[..., 0, None] + dx0 * ca - dy0 * sa       # (..., nE, P)
    py = x[..., 1, None] + dx0 * sa + dy0 * ca

    # pillar vs its own y-replica: direct (non-modular) metric, matching
    # geometry.min_pairwise_outline_distance
    d2s = ((px[..., :, None] - px[..., None, :]) ** 2
           + (py[..., :, None] - (py[..., None, :] + Ly)) ** 2)
    ok = ok & (torch.sqrt(d2s.amin((-3, -2, -1))) >= min_gap * lo)

    if nE >= 2:
        # every ordered pair (a, b) of distinct pillars, made on the device:
        # the JAX version's all-points matrix without its masked
        # same-pillar blocks
        a = torch.arange(nE, device=x.device).repeat_interleave(nE - 1)
        b = (a + torch.arange(1, nE, device=x.device).repeat(nE)) % nE
        dx = torch.remainder(px[..., a, :, None] - px[..., b, None, :], Lx)
        dx = torch.minimum(dx, Lx - dx)
        dy = torch.remainder(py[..., a, :, None] - py[..., b, None, :], Ly)
        dy = torch.minimum(dy, Ly - dy)
        d2 = dx * dx + dy * dy
        ok = ok & (torch.sqrt(d2.amin((-3, -2, -1))) >= min_gap * lo)

    if sim is not None:
        sim = torch.as_tensor(sim, dtype=x.dtype).to(x.device)
        rel_r = torch.abs(x[..., 2:4] - sim[:, 2:4]) / sim[:, 2:4]
        ok = ok & (rel_r.amax((-2, -1)) <= how_similar * hi)
        for col, period in ((0, Lx), (1, Ly), (4, 2 * pi)):
            d = torch.remainder(x[..., col] - sim[:, col], period)
            d = torch.minimum(d, period - d)
            ok = ok & (d.amax(-1) <= how_similar * period * hi)
    return ok


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------

def _unit_directions(nE, dtype, device="cpu"):
    """(2*nE*5, nE, 5) signed unit steps: coordinate (e, p) -> indices
    (e*5+p)*2 (minus) and (e*5+p)*2+1 (plus), the host loop's visit order
    within a coordinate (``for signed in (-size, size)``)."""
    steps = np.zeros((nE * 5 * 2, nE, 5))
    for e in range(nE):
        for p in range(5):
            size = 0.3 * degree if p == 4 else 1 * nm
            steps[(e * 5 + p) * 2, e, p] = -size
            steps[(e * 5 + p) * 2 + 1, e, p] = size
    return torch.as_tensor(steps, dtype=dtype, device=device)


def _ratchet_scan(f1, wfoms, wfeas):
    """Ratchet acceptance over walk steps 2..max (step 1 pre-accepted at
    FOM ``f1``): each step sticks iff all previous stuck, the step is
    feasible (the host builds candidates only up to the first infeasible
    one) and its FOM does not drop.  Returns (final fom, steps kept >= 1)
    as 0-d tensors.  While every earlier step stuck, the running FOM is the
    previous step's, so the scan is a prefix product."""
    prev = torch.cat([f1.reshape(1), wfoms[:-1]])
    stick = torch.cumprod((wfeas & (wfoms >= prev)).to(torch.int32), 0)
    n_more = stick.sum()
    last = wfoms.gather(0, (n_more - 1).clamp(min=0).reshape(1))[0]
    return torch.where(n_more > 0, last, f1), 1 + n_more


class TorchDraws:
    """The default draw source: a ``torch.Generator`` on ``device`` seeded
    by ``seed``.  ``permutation(n)`` ranks n uniform float64 keys (a stable
    sort, on the device); ``uniform(shape)`` is uniform in [-1, 1) in
    ``dtype``."""

    def __init__(self, seed, device, dtype):
        self.device, self.dtype = torch.device(device), dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def permutation(self, n):
        keys = torch.rand(n, generator=self.gen, dtype=torch.float64,
                          device=self.device)
        return torch.argsort(keys, stable=True)

    def uniform(self, shape):
        return torch.rand(shape, generator=self.gen, dtype=self.dtype,
                          device=self.device) * 2.0 - 1.0


def _fom_fn(N, Dx, Dy, n_slabs, taylor_terms, inphase, fff, hermitian_eps):
    """The FOM of a batch of candidates (B, nE, 5) -> (B,) on the engine's
    :func:`_fom_eval` with the full J1 branch (``small_u=False``)."""
    def fom_of(rows, mx, my, i0, tgt, Lx, Ly, h, *per_term):
        return _fom_eval(rows, mx, my, i0, tgt, Lx, Ly, h, *per_term, N=N,
                         Dx=Dx, Dy=Dy, n_slabs=n_slabs,
                         taylor_terms=taylor_terms, inphase=inphase,
                         small_u=False, fff=fff,
                         hermitian_eps=hermitian_eps)
    return fom_of


# --------------------------------------------------------------------------
# fused coordinate descent
# --------------------------------------------------------------------------

def _cd_run(N, Dx, Dy, n_slabs, taylor_terms, inphase, fff, hermitian_eps,
            nE, max_rounds, max_steps):
    """The coordinate-descent dispatch: ``run(xyrra, sim, how_similar,
    min_r, min_gap, draws, mx, my, i0, tgt, Lx, Ly, h, *per_term)`` runs up
    to ``max_rounds`` rounds from ``xyrra`` and returns (x, fom, stalled,
    rounds), x and fom as tensors on xyrra's device.  ``sim`` is always a
    tensor (the unconstrained case passes the start with
    ``how_similar=inf``).  The draw source carries its state across calls,
    so a split run equals an unsplit one."""
    fom1 = _fom_fn(N, Dx, Dy, n_slabs, taylor_terms, inphase, fff,
                   hermitian_eps)
    nC = nE * 5

    def run(xyrra, sim, how_similar, min_r, min_gap, draws, mx, my, i0, tgt,
            Lx, Ly, h, *per_term):
        dev, rdt = xyrra.device, xyrra.dtype
        dirs = _unit_directions(nE, rdt, dev)
        pair = torch.arange(2, device=dev)
        ks = torch.arange(2, max_steps + 1, dtype=rdt, device=dev)

        def fom_of(rows):
            return fom1(rows, mx, my, i0, tgt, Lx, Ly, h, *per_term)

        def feas_of(rows):
            return feasible_traced(rows, Lx, Ly, min_r, min_gap, sim=sim,
                                   how_similar=how_similar, margin=1e-5)

        x = xyrra
        fom_now = fom_of(x[None])[0]
        stalled, rounds = False, 0
        while not stalled and rounds < max_rounds:
            with trace.span("fused.round"):
                perm = draws.permutation(nC).to(dev)
                visit = (perm[:, None] * 2 + pair).reshape(-1)

                cands = x[None] + dirs                       # (nD, nE, 5)
                foms = fom_of(cands)                         # (nD,)
                ok = feas_of(cands) & (foms >= fom_now)
                ok_v = ok[visit]
                any_ok = ok_v.any()
                d_idx = visit.gather(
                    0, ok_v.to(torch.int32).argmax().reshape(1))
                direction = dirs.index_select(0, d_idx)[0]
                f1 = foms.index_select(0, d_idx)[0]

                walk = x[None] + ks[:, None, None] * direction
                wfoms = fom_of(walk)
                fom_w, kept = _ratchet_scan(f1, wfoms, feas_of(walk))

                x_new = x + kept.to(rdt) * direction
                x = torch.where(any_ok, x_new, x)
                fom_now = torch.where(any_ok, fom_w, fom_now)
                rounds += 1
                stalled = not bool(any_ok)     # the round's one host read
            trace.count("fused.rounds")
            trace.count("fused.host_reads")
        return x, fom_now, stalled, rounds

    return run


def _member_inputs(g, target_wavelength, numG, terms, static_override,
                   similar_to, how_similar, min_gap, device, dtype):
    """What both fused entry points hand their run: the static solve
    config, the order tensors and per-term values, and the trust-region and
    clearance inputs as tensors on the device."""
    cdt = cpx.complex_dtype(device, dtype)
    rdt = cpx.real_dtype(cdt)
    orders, n_slabs, taylor, hermitian, tgt, inph, per_term = _fom_inputs(
        g, target_wavelength, numG, terms, cdt)
    Dx, Dy = _order_bounds(orders)
    Dx, Dy, n_slabs, taylor = apply_static_override(
        static_override, Dx, Dy, n_slabs, taylor)
    mx, my, i0 = _order_tensors(orders, device)
    config = (len(orders), Dx, Dy, n_slabs, taylor, inph, True, hermitian)
    has_sim = similar_to is not None

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=rdt,
                               device=device)
    trust = (t(similar_to if has_sim else g.xyrra_list),
             t(how_similar if has_sim else np.inf), t(min_diameter / 2),
             t(min_distance if min_gap is None else min_gap))
    cell = (mx, my, i0, tgt, g.grating_period, g.lateral_period,
            g.cyl_height) + tuple(per_term)
    return config, trust, cell, rdt


@trace.traced("fused.call")
def optimize_fused(mygrating_start, target_wavelength=None, similar_to=None,
                   how_similar=None, numG=50, terms=None, seed=0,
                   max_rounds_per_dispatch=64, verbose=True,
                   static_override=None, min_gap=None, *, device="cuda",
                   dtype=None):
    """Coordinate-descent ratchet with the accept logic on the device (see
    the module docstring).  Same acceptance semantics as
    :func:`metalens_tpu_torch.optimize.optimize`; the shuffle comes from
    :class:`TorchDraws` seeded by ``seed``.  Returns an optimized copy.  ``max_rounds_per_dispatch`` splits the run into
    dispatches of at most that many rounds (each recomputes the start's
    FOM); the result does not depend on it.

    ``static_override``: optional ``(Dx, Dy, n_slabs, taylor_terms)``
    envelope (:func:`metalens_tpu_torch.engine.static_envelope`) that must
    cover this member's own config; ``vary_angle(use_fused=True)`` passes
    the envelope of its whole ladder, as the JAX package does.

    ``min_gap``: optional inflated pillar-clearance floor (metres; default
    the fabrication ``min_distance``), for continuation headroom: a member
    packed to exactly ``min_distance`` can be impossible to re-seed at the
    next period shrink.  If the start violates the inflated floor, no move
    is accepted until probes re-enter the inflated-feasible set; the result
    is always at least ``min_distance``-feasible.

    The package exports this function under the module's name, so
    ``metalens_tpu_torch.optimize_fused`` is the function; reach the module
    by ``importlib.import_module("metalens_tpu_torch.optimize_fused")``."""
    assert validate(mygrating_start, print_details=True,
                    similar_to=similar_to, how_similar=how_similar)
    device = _device(device)
    g = mygrating_start.copy()
    config, trust, cell, rdt = _member_inputs(
        g, target_wavelength, numG, terms, static_override, similar_to,
        how_similar, min_gap, device, dtype)
    run = _cd_run(*config, g.xyrra_list.shape[0],
                  int(max_rounds_per_dispatch), 10)
    draws = TorchDraws(seed, device, rdt)
    x = torch.as_tensor(g.xyrra_list, dtype=rdt, device=device)
    total_rounds = 0
    while True:
        x, fom_now, stalled, rounds = run(x, *trust, draws, *cell)
        total_rounds += rounds
        if stalled:
            break
    g.xyrra_list = x.cpu().numpy().astype(np.float64)
    trace.count("fused.host_reads")
    trace.count("fused.accepted", total_rounds - 1)
    g.standardize()
    assert validate(g, similar_to=similar_to, how_similar=how_similar)
    if verbose:
        print(f"#optimize_fused: fom={float(fom_now):.6f} "
              f"after {total_rounds - 1} accepted moves")
        print("mygrating=" + repr(g), flush=True)
        trace.count("fused.host_reads")
    return g


# --------------------------------------------------------------------------
# fused random perturbation
# --------------------------------------------------------------------------

def _rp_run(N, Dx, Dy, n_slabs, taylor_terms, inphase, fff, hermitian_eps,
            nE, max_steps):
    """The random-perturbation loop: ``run(xyrra, sim, how_similar, min_r,
    min_gap, draws, attempts, step_ceiling, mx, my, i0, tgt, Lx, Ly, h,
    *per_term)`` returns (x, fom, tried, accepted), x, fom and accepted as
    tensors on xyrra's device.  Nothing is read on the host."""
    fom1 = _fom_fn(N, Dx, Dy, n_slabs, taylor_terms, inphase, fff,
                   hermitian_eps)

    def run(xyrra, sim, how_similar, min_r, min_gap, draws, attempts,
            step_ceiling, mx, my, i0, tgt, Lx, Ly, h, *per_term):
        dev, rdt = xyrra.device, xyrra.dtype
        ks = torch.arange(1, max_steps + 1, dtype=rdt, device=dev)

        def fom_of(rows):
            return fom1(rows, mx, my, i0, tgt, Lx, Ly, h, *per_term)

        x = xyrra
        fom_now = fom_of(x[None])[0]
        accepted = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(int(attempts)):
            with trace.span("fused.attempt"):
                direction = step_ceiling * draws.uniform(x.shape).to(dev)
                # the proposal (step 1) and the ratchet walk's steps 2..max
                # in one batch
                walk = x[None] + ks[:, None, None] * direction
                afoms = fom_of(walk)
                feas = feasible_traced(walk, Lx, Ly, min_r, min_gap, sim=sim,
                                       how_similar=how_similar, margin=1e-5)
                f1 = afoms[0]
                ok1 = feas[0] & (f1 >= fom_now)
                fom_w, kept = _ratchet_scan(f1, afoms[1:], feas[1:])

                x = torch.where(ok1, x + kept.to(rdt) * direction, x)
                fom_now = torch.where(ok1, fom_w, fom_now)
                accepted = accepted + ok1.to(torch.int32)
            trace.count("fused.attempts")
        return x, fom_now, int(attempts), accepted

    return run


@trace.traced("fused.call")
def optimize2_fused(mygrating_start, target_wavelength=None, attempts=200,
                    similar_to=None, how_similar=None, numG=50, terms=None,
                    seed=0, verbose=True, static_override=None, min_gap=None,
                    *, device="cuda", dtype=None):
    """Random simultaneous perturbation with the accept logic on the device
    (semantics of :func:`metalens_tpu_torch.optimize.optimize2`: each
    attempt draws one uniform step for all coordinates at once, with the
    per-coordinate ceiling 1 nm / 0.1 deg divided by the coordinate count);
    the draws come from :class:`TorchDraws` seeded by ``seed``.
    ``static_override`` and ``min_gap``: see :func:`optimize_fused`."""
    assert validate(mygrating_start, print_details=True,
                    similar_to=similar_to, how_similar=how_similar)
    device = _device(device)
    g = mygrating_start.copy()
    config, trust, cell, rdt = _member_inputs(
        g, target_wavelength, numG, terms, static_override, similar_to,
        how_similar, min_gap, device, dtype)
    run = _rp_run(*config, g.xyrra_list.shape[0], 10)
    step_ceiling = np.empty_like(g.xyrra_list)
    step_ceiling[:, 0:4] = 1 * nm
    step_ceiling[:, 4] = 0.1 * degree
    step_ceiling /= g.xyrra_list.size
    draws = TorchDraws(seed, device, rdt)
    x, fom_now, tried, accepted = run(
        torch.as_tensor(g.xyrra_list, dtype=rdt, device=device), *trust,
        draws, attempts, torch.as_tensor(step_ceiling, dtype=rdt,
                                         device=device), *cell)
    g.xyrra_list = x.cpu().numpy().astype(np.float64)
    trace.count("fused.host_reads")
    g.standardize()
    assert validate(g, similar_to=similar_to, how_similar=how_similar)
    if trace.enabled():
        trace.count("fused.accepted", int(accepted))
    if verbose:
        print(f"#optimize2_fused: fom={float(fom_now):.6f} after {tried} "
              f"attempts ({int(accepted)} accepted)")
        print("mygrating=" + repr(g), flush=True)
        trace.count("fused.host_reads", 2)
    return g


# --------------------------------------------------------------------------
# best-of-k seeded restarts
# --------------------------------------------------------------------------

def optimize_multistart(mygrating_start, k=8, target_wavelength=None,
                        similar_to=None, how_similar=None, numG=50,
                        terms=None, seed=0, attempts=200, verbose=True,
                        static_override=None, accept=None, min_gap=None, *,
                        device="cuda", dtype=None):
    """Best-of-``k`` seeded restarts of the fused optimize -> optimize2
    chain from the same start; returns ``(best_grating, foms)`` with
    ``foms`` the k restart scores in seed order.  Restart i runs
    :func:`optimize_fused` with seed ``seed + 2i`` and
    :func:`optimize2_fused` with ``seed + 2i + 1``; each restart is
    rescored once by :meth:`Grating.fom`, so all k values come from the
    same computation rather than each chain's running value.

    ``accept``: optional predicate ``grating -> bool``; restarts failing it
    still appear in ``foms`` but are excluded from the best (the motivating
    gate is continuation feasibility: a member on the ``min_distance``
    boundary cannot be resized to the next rung).  Raises ``ValueError`` if
    no restart is accepted."""
    assert k >= 1
    best_f, best_g, foms = -np.inf, None, []
    common = dict(target_wavelength=target_wavelength,
                  similar_to=similar_to, how_similar=how_similar, numG=numG,
                  terms=terms, verbose=verbose,
                  static_override=static_override, min_gap=min_gap,
                  device=device, dtype=dtype)
    for i in range(int(k)):
        g = optimize_fused(mygrating_start, seed=seed + 2 * i, **common)
        g = optimize2_fused(g, attempts=attempts, seed=seed + 2 * i + 1,
                            **common)
        f = g.fom(target_wavelength=target_wavelength, numG=numG,
                  terms=terms, device=device, dtype=dtype)
        foms.append(f)
        if f > best_f and (accept is None or accept(g)):
            best_f, best_g = f, g
    if best_g is None:
        raise ValueError(f"no restart of k={k} passed the accept gate")
    if verbose:
        print(f"#optimize_multistart: best fom={best_f:.6f} of k={k} "
              f"(spread {min(foms):.4f}-{max(foms):.4f})", flush=True)
    return best_g, foms
