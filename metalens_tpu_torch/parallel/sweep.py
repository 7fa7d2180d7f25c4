"""Sharded solve batches: the reference's process fan-out
(``grating.py:1062-1072``) as one process per device.

Counterpart of ``metalens_tpu/parallel/sweep.py``.  A batch of B unit
cells (same pillar count; periods and geometry may differ) is split into
contiguous blocks, one per rank; every rank passes the same global inputs
and solves its own block through the port's batched cell solve
(:func:`metalens_tpu_torch.solver.rcwa.cell_amplitudes`, the hand-written
kernels on the card, their backward passes for the gradient); collectives
combine the results.  One call of :func:`sharded_fom_and_grad` is the
framework's data-parallel training step: B FOM evaluations and their exact
geometry gradients.

The JAX package vmaps over a per-cell period.  The port's eps front end
takes one period per call, so a rank groups its cells by (Lx, Ly), solves
each group as one batch and puts the results back in cell order.

Per-cell inputs given as tensors stay where they are: a rank slices its
block on the device.  The periods and the scalars are read on the host, a
tensor among them once until it changes in place.

Both functions take ``dtype=`` (the complex working dtype; default
complex128 on the CPU, complex64 on CUDA) and run on the mesh's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..solver import basis, cpx, orders as ordmod, rcwa
from ..solver.fom import term_score


def _groups(Lx, Ly):
    """(Lx, Ly, indices) for each distinct period pair of a block, in the
    order of first appearance."""
    pairs = {}
    for i, key in enumerate(zip(Lx.tolist(), Ly.tolist())):
        pairs.setdefault(key, []).append(i)
    return [(lx, ly, idx) for (lx, ly), idx in pairs.items()]


class _HostInputs:
    """Host copies of the inputs the solve takes as numbers: the periods
    (to group the cells) and the scalars.  A tensor is read once, and again
    only after an in-place change, so a loop that passes the same device
    tables on every call syncs with the device on its first call only;
    arrays and numbers are converted on the host."""

    def __init__(self):
        self._memo = {}

    def __call__(self, name, x, dtype=np.float64):
        if not torch.is_tensor(x):
            return np.asarray(x, dtype=dtype)
        hit = self._memo.get(name)
        if hit is None or hit[0] is not x or hit[1] != x._version:
            hit = (x, x._version,
                   np.asarray(x.detach().cpu().numpy(), dtype=dtype))
            self._memo[name] = hit
        return hit[2]


class _Grouping:
    """A block's period groups, ``(Lx, Ly, indices)`` with the indices on
    the device, kept while the block's periods stay the same.  The indices
    are None where one group holds the whole block."""

    def __init__(self, device):
        self.device = device
        self._key = self._groups = None

    def __call__(self, Lx, Ly):
        key = (Lx.tobytes(), Ly.tobytes())
        if key != self._key:
            groups = _groups(Lx, Ly)
            self._key = key
            self._groups = (
                [(groups[0][0], groups[0][1], None)] if len(groups) == 1
                else [(lx, ly, torch.as_tensor(idx, device=self.device))
                      for lx, ly, idx in groups])
        return self._groups


def _take(t, sel):
    return t if sel is None else t.index_select(0, sel)


def incidence_sp(u, N, i0, cdt):
    """Per-cell incidence columns (B, 2N, 2): the s and p plane waves in
    air at (ux, 0) on the order (0, 0) of an N-order set."""
    c = torch.zeros((len(u), 2 * N, 2), dtype=cdt, device=u.device)
    c[:, i0, 0], c[:, i0 + N, 0] = basis.incident_sp_amplitudes(u, 0.0 * u,
                                                                 "s")
    c[:, i0, 1], c[:, i0 + N, 1] = basis.incident_sp_amplitudes(u, 0.0 * u,
                                                                 "p")
    return c


def _block(mesh, x, rdt):
    """This rank's block of a per-cell array (a tensor is sliced where it
    lies), as a real tensor on the mesh's device."""
    lo, hi = mesh.block(len(x))
    return torch.as_tensor(x[lo:hi], dtype=rdt, device=mesh.device).detach()


def sharded_fom_and_grad(mesh, orders, n_slabs, target_idx, inphase,
                         taylor_terms=12, axis_name="cells", fff=True, *,
                         dtype=None):
    """Return the sharded step

        (xyrra[B, nE, 5], Lx[B], Ly[B], h, eps_p[T], eps_g[T], lam[T],
         ux[B, T], ng_now[T], cos_theta[B, T], weights[T])
            -> (mean_fom (0-d), d mean_fom / d xyrra [B, nE, 5])

    with the JAX package's arguments and meaning: each cell's FOM is the
    weighted mean of its T terms (incidence (ux, 0) in air, both
    polarizations, the target order's transmitted amplitudes scored by
    :func:`term_score`), and the step returns the mean over the batch and
    its gradient for the whole batch.  Every rank passes the same global
    inputs (arrays, tensors or numbers; the permittivities complex); B
    must divide over the ranks.  Each rank solves its contiguous block;
    the mean is combined by ``all_reduce`` and the gradient all-gathered,
    both returned as tensors on the mesh's device in the working real
    dtype.

    ``n_slabs`` and ``taylor_terms`` must be a converged pairing (take both
    from :func:`metalens_tpu_torch.solver.rcwa.slab_schedule`)."""
    orders = np.asarray(orders)
    N = orders.shape[0]
    i0 = ordmod.order_index(orders, 0, 0)
    rdt = cpx.real_dtype(cpx.complex_dtype(mesh.device, dtype))
    cdt = cpx.to_complex(rdt)
    target_idx, inphase = tuple(target_idx), tuple(inphase)
    host, grouping = _HostInputs(), _Grouping(mesh.device)

    def fom_and_grad(xyrra, Lx, Ly, h, eps_p, eps_g, lam, ux, ng_now,
                     cos_theta, weights):
        B = len(xyrra)
        lo, hi = mesh.block(B)
        x = _block(mesh, xyrra, rdt).requires_grad_(True)
        ux_b, cth_b = _block(mesh, ux, rdt), _block(mesh, cos_theta, rdt)
        h = host("h", h).item()
        eps_p, eps_g = (host(k, v, np.complex128).reshape(-1).tolist()
                        for k, v in (("eps_p", eps_p), ("eps_g", eps_g)))
        lam, ng_now, weights = (
            host(k, v).reshape(-1).tolist() for k, v in
            (("lam", lam), ("ng_now", ng_now), ("weights", weights)))
        local = 0.0
        for lx, ly, sel in grouping(host("Lx", Lx)[lo:hi],
                                    host("Ly", Ly)[lo:hi]):
            xg = _take(x, sel)
            total = 0.0
            for t in range(len(target_idx)):
                u = _take(ux_b[:, t], sel)
                ampf, _, _, _ = rcwa.cell_amplitudes(
                    orders, xg, lx, ly, h, eps_p[t], eps_g[t], lam[t], u,
                    0.0, incidence_sp(u, N, i0, cdt), n_slabs=n_slabs,
                    taylor_terms=taylor_terms, fff=fff,
                    want_reflection=False)
                k = target_idx[t]
                total = total + weights[t] * term_score(
                    ampf[:, k, 0], ampf[:, k + N, 1], ng_now[t],
                    _take(cth_b[:, t], sel), inphase[t])
            local = local + (total / sum(weights)).sum()
        local = local / B
        grad, = torch.autograd.grad(local, x)
        return mesh.all_reduce(local), mesh.all_gather(grad)

    return fom_and_grad


def sharded_characterize_amps(mesh, orders, n_slabs, taylor_terms=12,
                              axis_name="cells", fff=True, *, dtype=None):
    """Return the sharded characterize sweep over a (direction x cell)
    batch:

        (xyrra[B, nE, 5], Lx[B], Ly[B], h, eps_p, eps_g, lam, ux[B], uy[B])
            -> (ampf [B, 2, 2N], ampr [B, 2, 2N])

    (unit 'y' and 'x' incidence in the S4 x/y basis, pol axis 1; complex
    tensors on the mesh's device, all-gathered).  Every rank passes the
    same global inputs; B must divide over the ranks.

    ``orders`` is either the JAX package's form, an (N, 2) order array
    shared by every cell, whatever its period: amplitude index i is then
    the order ``orders[i]`` (and ``orders[i]`` in the x half, i + N) in
    every row of the output.  Or it is the int numG: each period then
    solves on its own :func:`select_orders` set -- the set
    ``characterize_grating`` uses -- and index i of row b is the i-th order
    of the set ``select_orders(Lx[b], Ly[b], numG)``, so one index may name
    other orders in rows of other periods.  ``n_slabs=None`` sizes each
    period's slab schedule as ``characterize_grating`` does
    (``taylor_terms`` is then the schedule's)."""
    rdt = cpx.real_dtype(cpx.complex_dtype(mesh.device, dtype))
    cdt = cpx.to_complex(rdt)
    shared = None if np.ndim(orders) == 0 else np.asarray(orders)
    host, grouping = _HostInputs(), _Grouping(mesh.device)

    @trace.traced("parallel.sweep")
    def amps(xyrra, Lx, Ly, h, eps_p, eps_g, lam, ux, uy):
        B = len(xyrra)
        lo, hi = mesh.block(B)
        x = _block(mesh, xyrra, rdt)
        ux_b, uy_b = _block(mesh, ux, rdt), _block(mesh, uy, rdt)
        h, lam = host("h", h).item(), host("lam", lam).item()
        eps_p, eps_g = (host(k, v, np.complex128).item()
                        for k, v in (("eps_p", eps_p), ("eps_g", eps_g)))
        out_f = out_r = None
        for lx, ly, sel in grouping(host("Lx", Lx)[lo:hi],
                                    host("Ly", Ly)[lo:hi]):
            o = (ordmod.select_orders(lx, ly, orders) if shared is None
                 else shared)
            N = o.shape[0]
            ns, tt = n_slabs, taylor_terms
            if ns is None:
                ns, tt = rcwa.slab_schedule(
                    2 * np.pi * h / lam, o, lx, ly, lam,
                    max(abs(eps_p), abs(eps_g)), dtype=cdt)
            i0 = ordmod.order_index(o, 0, 0)
            c = torch.zeros((2 * N, 2), dtype=cdt, device=mesh.device)
            c[i0, 0] = c[i0 + N, 1] = 1.0
            af, ar, _, _ = rcwa.cell_amplitudes(
                o, _take(x, sel), lx, ly, h, eps_p, eps_g, lam,
                _take(ux_b, sel), _take(uy_b, sel), c, n_slabs=ns,
                taylor_terms=tt, fff=fff)
            af, ar = af.transpose(1, 2), ar.transpose(1, 2)
            if sel is None:
                out_f, out_r = af, ar
                continue
            if out_f is None:
                out_f = torch.empty((hi - lo, 2, 2 * N), dtype=cdt,
                                    device=mesh.device)
                out_r = torch.empty_like(out_f)
            out_f[sel], out_r[sel] = af, ar
        return mesh.all_gather(out_f), mesh.all_gather(out_r)

    return amps
