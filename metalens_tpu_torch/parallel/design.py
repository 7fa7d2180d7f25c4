"""Sharded design: independent fused-optimizer members, one per rank.

Counterpart of ``metalens_tpu/parallel/design.py``.  Design members are
independent work items (the reference fanned them out as OS processes,
``grating.py:1062-1072``); here each rank of the mesh runs the full fused
chain of :mod:`metalens_tpu_torch.optimize_fused` -- the coordinate-descent
ratchet, then the random perturbation -- on its own member, on its own
device.  The ranks meet only to agree on the static solve configuration,
to decide whether another coordinate-descent dispatch is needed, and to
gather the results.

Members must share the pillar count, the order count, the FOM terms'
in-phase flags and the eps routing (one ``vary_angle`` bracket or seed
restart family); ``n_slabs``, ``taylor_terms`` and the difference-grid
bounds are maxed across the members, which is conservative-exact (more
slabs shrink each slab's Taylor argument).

Two production uses: seed restarts (K seeds of one member at once, keep
the best) and bracket seeds (each bracket's seed member of a multi-bracket
design at once, before the sequential ``vary_angle`` continuations).  Left
behind as JAX or TPU workarounds: the ``FUSED_PROBE_BATCH`` padding, the
``check_vma`` switch and the stacking of the members' inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import _fom_inputs, _order_bounds
from ..grating import validate
from ..optimize_fused import TorchDraws, _cd_run, _member_inputs, _rp_run
from ..solver import cpx
from ..units import degree, nm


def _envelope(mesh, g, target_wavelength, numG, terms, dtype):
    """The static solve configuration every rank runs: the shared parts
    checked equal across ranks, ``(Dx, Dy, n_slabs, taylor_terms)`` maxed
    (a ``static_override`` that covers every member)."""
    orders, n_slabs, taylor, herm, _, inph, _ = _fom_inputs(
        g, target_wavelength, numG, terms,
        cpx.complex_dtype(mesh.device, dtype))
    mine = dict(shared=(len(orders), inph, herm, g.xyrra_list.shape[0]),
                grown=_order_bounds(orders) + (n_slabs, taylor))
    every = mesh.all_gather_object(mine)
    shared = {m["shared"] for m in every}
    if len(shared) != 1:
        raise ValueError(f"members disagree on (order count, in-phase "
                         f"flags, Hermitian eps, pillar count): {shared}")
    return tuple(max(m["grown"][k] for m in every) for k in range(4))


def sharded_member_optimize(mesh, gratings, target_wavelength=None,
                            numG=50, terms=None, seeds=None, attempts=200,
                            similar_to=None, how_similar=None,
                            max_rounds_per_dispatch=256, max_dispatches=32,
                            *, verbose=True, axis="cells", dtype=None):
    """Run ``optimize_fused`` + ``optimize2_fused`` on every member of
    ``gratings``, one member per rank of ``mesh``.  Every rank passes the
    same arguments.

    The member list is padded to the world size by repeating the last
    member (its results are discarded).  Rank i runs the coordinate-descent
    dispatches of :func:`_cd_run` from member i with draws from
    :class:`TorchDraws` seeded ``seeds[i]`` (default ``range(len(
    gratings))``), while any rank is not stalled, at most
    ``max_dispatches`` times; a stalled rank waits.  Then it runs
    :func:`_rp_run` for ``attempts`` with draws seeded ``seeds[i] + 1``.
    Returns ``(optimized_gratings, foms)``, gathered on every rank; the
    FOMs are the chains' own values.  ``dtype`` is the complex working
    dtype (the port's convention), in place of the JAX signature's real
    ``rdtype``; the arguments after ``max_dispatches`` are keywords, so a
    call in the JAX signature's positions fails rather than misreads."""
    M = len(gratings)
    if not 1 <= M <= mesh.size:
        raise ValueError(f"{M} members for {mesh.size} ranks")
    for i, g in enumerate(gratings):
        assert validate(g, print_details=True,
                        similar_to=None if similar_to is None
                        else similar_to[i], how_similar=how_similar)
    seeds = list(seeds) if seeds is not None else list(range(M))
    if len(seeds) != M:
        raise ValueError(f"{len(seeds)} seeds for {M} members")
    pad = mesh.size - M
    padded = list(gratings) + [gratings[-1]] * pad
    seeds = seeds + [seeds[-1] + 7919 * (i + 1) for i in range(pad)]
    sims = (list(similar_to) + [similar_to[-1]] * pad
            if similar_to is not None else None)

    i = mesh.rank
    g = padded[i]
    sim = None if sims is None else sims[i]
    envelope = _envelope(mesh, g, target_wavelength, numG, terms, dtype)
    config, trust, cell, rdt = _member_inputs(
        g, target_wavelength, numG, terms, envelope, sim, how_similar, None,
        mesh.device, dtype)
    nE = g.xyrra_list.shape[0]

    cd = _cd_run(*config, nE, int(max_rounds_per_dispatch), 10)
    draws = TorchDraws(seeds[i], mesh.device, rdt)
    x = torch.as_tensor(g.xyrra_list, dtype=rdt, device=mesh.device)
    stalled = False
    for _ in range(int(max_dispatches)):
        if not stalled:
            x, fom_now, stalled, _ = cd(x, *trust, draws, *cell)
        if not mesh.any(not stalled):
            break

    step_ceiling = np.empty_like(g.xyrra_list)
    step_ceiling[:, 0:4] = 1 * nm
    step_ceiling[:, 4] = 0.1 * degree
    step_ceiling /= g.xyrra_list.size
    rp = _rp_run(*config, nE, 10)
    x, fom_now, _, _ = rp(x, *trust, TorchDraws(seeds[i] + 1, mesh.device,
                                                rdt), attempts,
                          torch.as_tensor(step_ceiling, dtype=rdt,
                                          device=mesh.device), *cell)

    x_all = mesh.all_gather(x.to(torch.float64)[None]).cpu().numpy()
    f_all = mesh.all_gather(fom_now.reshape(1).to(torch.float64)).cpu()
    out, foms = [], []
    for k in range(M):
        gk = gratings[k].copy()
        gk.xyrra_list = x_all[k].copy()
        gk.standardize()
        assert validate(gk, similar_to=None if sims is None else sims[k],
                        how_similar=how_similar)
        out.append(gk)
        foms.append(float(f_all[k]))
    if verbose:
        print(f"#sharded_member_optimize: {M} members over {mesh.size} "
              f"ranks, foms={['%.4f' % f for f in foms]}", flush=True)
    return out, foms
