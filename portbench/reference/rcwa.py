"""Plain RCWA of a unit cell of elliptical pillars: the benchmark's reference.

Plain PyTorch, written for this benchmark and importing nothing of the
program under test.  It computes the same physics as the program's cell
solve, by other means where there are other means:

* the Laurent eps Toeplitz from the analytic ellipse transform, with
  ``torch.special.bessel_j1``;
* the normal-vector (NV) factorization: the nearest-pillar normal field on an
  R x R raster, its Fourier coefficients by ``torch.fft.fft2``, and the
  anticommutator form sym(D P) = (D P + P D) / 2;
* each sub-slab's field transfer matrix by ``torch.linalg.matrix_exp`` (no
  Taylor series), turned into a scattering matrix and doubled by the general
  Redheffer star with pivoted solves (``torch.linalg.solve``).

Conventions (the published S4 conventions the program also follows): the
amplitude vector of a uniform medium is c = [c_y (N orders); c_x (N
orders)], the transverse H of a forward mode is (hx, hy) = (c_y, c_x), time
goes as e^{-i w t}, and the cell's S-matrix maps the incident amplitudes in
air to the transmitted ones in glass (s11) and the reflected ones in air
(s21).

Precision: every function runs in the dtype of its input geometry (float64
-> complex128).  ``Precision("tf32")`` rounds both operands of every matrix
product to TF32 (10 mantissa bits, round to nearest even) before a float32
product: the control, the reference one precision step below the program's
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
EPS_REF = 1.5 + 1.0j      # lossy internal basis of the slabs: no grazing order
BRANCH_EPS = 1e-9         # nudge onto the Im kz >= 0 branch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with each float32 component rounded to TF32's 10 mantissa bits."""
    if x.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(x)))
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = ((bits + 0x0FFF + lsb) >> 13) << 13
    return bits.view(torch.float32)


class Precision:
    """Matrix products at full precision ("full") or with TF32 operands
    ("tf32", float32 only)."""

    def __init__(self, mode: str = "full"):
        if mode not in ("full", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def mm(self, a, b):
        if self.mode == "tf32":
            if a.dtype != torch.complex64:
                raise TypeError("tf32 products take complex64 operands")
            return round_tf32(a) @ round_tf32(b)
        return a @ b


FULL = Precision("full")


# ----- orders -----

def select_orders(Lx: float, Ly: float, numG: int) -> np.ndarray:
    """The numG reciprocal-lattice orders (mx, my) of smallest |G| on the
    rectangular lattice, ties broken by (mx, my); (0, 0) first."""
    gx, gy = TWO_PI / Lx, TWO_PI / Ly
    m = int(math.ceil(math.sqrt(numG) * max(gx, gy) / min(gx, gy))) + 2
    mx, my = np.meshgrid(np.arange(-m, m + 1), np.arange(-m, m + 1),
                         indexing="ij")
    mx, my = mx.ravel(), my.ravel()
    norm2 = (mx * gx) ** 2 + (my * gy) ** 2
    idx = np.lexsort((my, mx, norm2))[:numG]
    # the last kept order must lie strictly inside the searched box
    assert norm2[idx[-1]] < (m * min(gx, gy)) ** 2
    return np.stack([mx[idx], my[idx]], axis=1)


def order_index(orders: np.ndarray, ox: int, oy: int) -> int:
    hit = np.nonzero((orders[:, 0] == ox) & (orders[:, 1] == oy))[0]
    if len(hit) != 1:
        raise ValueError(f"order ({ox}, {oy}) not in the order set")
    return int(hit[0])


# ----- eps front end -----

def _j1_over_x(u: torch.Tensor) -> torch.Tensor:
    small = u < 1e-6
    safe = torch.where(small, torch.ones_like(u), u)
    return torch.where(small, 0.5 - u * u / 16.0,
                       torch.special.bessel_j1(safe) / safe)


def structure_factor(gx, gy, xyrra, area):
    """S(g) = (1/area) sum_e FT[ellipse e](g) for wavevectors gx, gy (K,):
    (B, nE, 5) -> (B, K) complex."""
    x0, y0, rx, ry, a = (xyrra[..., None, :, k] for k in range(5))
    ca, sa = torch.cos(a), torch.sin(a)
    g1 = gx[:, None] * ca + gy[:, None] * sa
    g2 = -gx[:, None] * sa + gy[:, None] * ca
    u = torch.sqrt((g1 * rx) ** 2 + (g2 * ry) ** 2)
    ft = TWO_PI * rx * ry * _j1_over_x(u)
    phase = -(gx[:, None] * x0 + gy[:, None] * y0)
    return torch.polar(ft, phase).sum(-1) / area


def _diff_grid(orders):
    dmx = orders[:, 0][:, None] - orders[:, 0][None, :]
    dmy = orders[:, 1][:, None] - orders[:, 1][None, :]
    return dmx, dmy


def toeplitz(orders, Lx, Ly, xyrra):
    """(S, at_zero): the structure Toeplitz S[i, j] = S(G_i - G_j) (B, N, N)
    and the mask of the zero difference, so that
    <<eps>> = eps_bg at_zero + (eps_fill - eps_bg) S."""
    dmx, dmy = _diff_grid(orders)
    kw = dict(dtype=xyrra.dtype, device=xyrra.device)
    gx = torch.as_tensor(dmx.ravel(), **kw) * (TWO_PI / Lx)
    gy = torch.as_tensor(dmy.ravel(), **kw) * (TWO_PI / Ly)
    N = len(orders)
    S = structure_factor(gx, gy, xyrra, Lx * Ly).reshape(-1, N, N)
    at_zero = torch.as_tensor((dmx == 0) & (dmy == 0), **kw)
    return S, at_zero


def normal_field(xyrra, Lx, Ly, R):
    """(nx, ny) (B, R, R) of the nearest pillar's outward normal at the
    raster points ((i + 1/2)/R - 1/2) L of the cell; "nearest" is the least
    |u - 1|, u the point's scaled radius in the pillar's own axes, with
    periodic displacements."""
    f = (torch.arange(R, dtype=xyrra.dtype, device=xyrra.device) + 0.5) / R \
        - 0.5
    X = (f * Lx)[:, None].expand(R, R)
    Y = (f * Ly)[None, :].expand(R, R)
    best = None
    for e in range(xyrra.shape[-2]):
        x0, y0, rx, ry, a = (xyrra[:, e, k, None, None] for k in range(5))
        dx = X - x0
        dx = dx - Lx * torch.round(dx / Lx)
        dy = Y - y0
        dy = dy - Ly * torch.round(dy / Ly)
        ca, sa = torch.cos(a), torch.sin(a)
        xp = dx * ca + dy * sa
        yp = -dx * sa + dy * ca
        d = torch.abs(torch.sqrt((xp / rx) ** 2 + (yp / ry) ** 2 + 1e-30)
                      - 1.0)
        gxp, gyp = xp / rx ** 2, yp / ry ** 2
        norm = torch.sqrt(gxp ** 2 + gyp ** 2 + 1e-30)
        nx = (gxp * ca - gyp * sa) / norm
        ny = (gxp * sa + gyp * ca) / norm
        if best is None:
            best, nx_b, ny_b = d, nx, ny
        else:
            take = d < best
            nx_b = torch.where(take, nx, nx_b)
            ny_b = torch.where(take, ny, ny_b)
            best = torch.minimum(best, d)
    return nx_b, ny_b


def projector_toeplitz(orders, Lx, Ly, xyrra, R=64):
    """Toeplitz blocks (Pxx, Pxy, Pyy) (B, N, N) of the normal projector
    n_i n_j, its Fourier coefficients taken by FFT over the raster."""
    dmx, dmy = _diff_grid(orders)
    if np.abs(dmx).max() >= R // 2 or np.abs(dmy).max() >= R // 2:
        raise ValueError("order differences alias on the raster")
    nx, ny = normal_field(xyrra, Lx, Ly, R)
    dev = xyrra.device
    kx = torch.as_tensor(dmx % R, device=dev)
    ky = torch.as_tensor(dmy % R, device=dev)
    # raster offset: f = i/R + (1/(2R) - 1/2)
    off = (0.5 / R - 0.5) * TWO_PI
    shift = torch.polar(torch.ones((), dtype=xyrra.dtype, device=dev),
                        torch.as_tensor(-off * (dmx + dmy), dtype=xyrra.dtype,
                                        device=dev))
    out = []
    for field in (nx * nx, nx * ny, ny * ny):
        F = torch.fft.fft2(field.to(torch.complex128 if field.dtype ==
                                    torch.float64 else torch.complex64))
        out.append(F[:, kx, ky] * shift / (R * R))
    return tuple(out)


def eps_blocks(orders, Lx, Ly, xyrra, eps_p, nv=True, eps_bg=1.0,
               prec=FULL):
    """<<eps>> and the in-plane eps operator (Mxx, Mxy, Myy): with ``nv``
    the NV-corrected blocks, else the Laurent rule (None)."""
    S, z = toeplitz(orders, Lx, Ly, xyrra)
    E = S * (complex(eps_p) - eps_bg) + z * eps_bg
    if not nv:
        return E, None
    inv_p, inv_bg = 1.0 / complex(eps_p), 1.0 / eps_bg
    E_recip = S * (inv_p - inv_bg) + z * inv_bg
    Delta = E - torch.linalg.inv(E_recip)
    P = projector_toeplitz(orders, Lx, Ly, xyrra)

    def sym(Pk):
        return (prec.mm(Delta, Pk) + prec.mm(Pk, Delta)) * 0.5
    return E, (E - sym(P[0]), -sym(P[1]), E - sym(P[2]))


# ----- uniform media -----

def kz(Kx, Ky, eps):
    e = complex(eps)
    arg = torch.complex(e.real - Kx * Kx - Ky * Ky,
                        torch.full_like(Kx, e.imag + BRANCH_EPS))
    return torch.sqrt(arg)     # principal root: Im >= 0 for Im(arg) >= 0


def medium_matrix(Kx, Ky, eps):
    """Phi (B, 4N, 4N): [e; h] = Phi [c_f; c_b] in the uniform medium eps,
    with e = W (c_f - c_b), h = c_f + c_b and W the E-from-amplitude map of
    forward modes."""
    Kz = kz(Kx, Ky, eps)
    n2 = complex(eps)
    n2Kz = n2 * Kz
    KxKy = (Kx * Ky).to(Kz.dtype)
    A = KxKy / n2Kz
    Bm = (Kz * Kz + Ky * Ky) / n2Kz
    C = -(Kz * Kz + Kx * Kx) / n2Kz
    W = torch.cat([torch.cat([torch.diag_embed(A), torch.diag_embed(Bm)], -1),
                   torch.cat([torch.diag_embed(C), torch.diag_embed(-A)], -1)],
                  -2)
    I = torch.eye(W.shape[-1], dtype=W.dtype, device=W.device).expand_as(W)
    return torch.cat([torch.cat([W, -W], -1), torch.cat([I, I], -1)], -2)


# ----- scattering matrices -----

def transfer_to_s(M, prec=FULL):
    """[c_f; c_b](bottom) = M [c_f; c_b](top) -> (s11, s12, s21, s22) with
    c_f(bot) = s11 c_f(top) + s12 c_b(bot),
    c_b(top) = s21 c_f(top) + s22 c_b(bot)."""
    n = M.shape[-1] // 2
    M11, M12 = M[..., :n, :n], M[..., :n, n:]
    M21, M22 = M[..., n:, :n], M[..., n:, n:]
    I = torch.eye(n, dtype=M.dtype, device=M.device).expand_as(M22)
    X = torch.linalg.solve(M22, torch.cat([M21, I], -1))
    s21, s22 = -X[..., :n], X[..., n:]
    return (M11 + prec.mm(M12, s21), prec.mm(M12, s22), s21, s22)


def star(A, B, prec=FULL):
    """Redheffer star of A (top) on B (bottom)."""
    a11, a12, a21, a22 = A
    b11, b12, b21, b22 = B
    n = a11.shape[-1]
    I = torch.eye(n, dtype=a11.dtype, device=a11.device)
    X = torch.linalg.solve(I - prec.mm(a12, b21),
                           torch.cat([a11, prec.mm(a12, b22)], -1))
    Xa11, Xa12b22 = X[..., :n], X[..., n:]
    Y = torch.linalg.solve(I - prec.mm(b21, a12),
                           torch.cat([b21, b22], -1))
    Yb21, Yb22 = Y[..., :n], Y[..., n:]
    return (prec.mm(b11, Xa11), b12 + prec.mm(b11, Xa12b22),
            a21 + prec.mm(a22, prec.mm(Yb21, a11)), prec.mm(a22, Yb22))


def slab_count(k0h: float, orders, Lx, Ly, lam, eps_max, u_max=1.0,
               cap=8.0):
    """Power-of-two sub-slab count with t * q_max <= cap."""
    kx = orders[:, 0] * lam / Lx
    ky = orders[:, 1] * lam / Ly
    q = math.sqrt((float(np.sqrt(kx ** 2 + ky ** 2).max()) + u_max) ** 2
                  + eps_max)
    n = max(1.0, k0h * q / cap)
    return int(2 ** math.ceil(math.log2(n)))


def cell_smatrix(orders, xyrra, Lx, Ly, h, eps_p, eps_g, lam, ux, uy,
                 nv=True, prec=FULL):
    """Air / pillar layer / glass S-matrix of a batch of cells ``xyrra``
    (B, nE, 5) at one wavelength, eps and incidence (ux, uy) each a number
    or a (B,) tensor.  Returns ((s11, s12, s21, s22), Kx, Ky)."""
    rdt, dev = xyrra.dtype, xyrra.device
    B = xyrra.shape[0]
    o = torch.as_tensor(orders, dtype=rdt, device=dev)

    def col(v):
        return torch.as_tensor(v, dtype=rdt, device=dev).reshape(-1, 1) \
            .expand(B, 1)
    Kx = col(ux) + o[None, :, 0] * (lam / Lx)
    Ky = col(uy) + o[None, :, 1] * (lam / Ly)
    E, Mb = eps_blocks(orders, Lx, Ly, xyrra, eps_p, nv=nv, prec=prec)
    cdt = E.dtype
    N = len(orders)
    Einv = torch.linalg.inv(E)
    KxE = Einv * Kx[..., :, None]
    KyE = Einv * Ky[..., :, None]
    I = torch.eye(N, dtype=cdt, device=dev)
    F = torch.cat([torch.cat([KxE * Ky[..., None, :],
                              I - KxE * Kx[..., None, :]], -1),
                   torch.cat([KyE * Ky[..., None, :] - I,
                              -KyE * Kx[..., None, :]], -1)], -2)
    dKxKy = torch.diag_embed(Kx * Ky).to(cdt)
    dKx2 = torch.diag_embed(Kx * Kx).to(cdt)
    dKy2 = torch.diag_embed(Ky * Ky).to(cdt)
    Mxx, Mxy, Myy = Mb if Mb is not None else (E, torch.zeros_like(E), E)
    G = torch.cat([torch.cat([-Mxy - dKxKy, dKx2 - Myy], -1),
                   torch.cat([Mxx - dKy2, Mxy + dKxKy], -1)], -2)
    k0h = TWO_PI * h / lam
    eps_max = max(abs(complex(eps_p)), abs(complex(eps_g)), 1.0)
    n_slabs = slab_count(k0h, orders, Lx, Ly, lam, eps_max)
    t = k0h / n_slabs
    Z = torch.zeros_like(F)
    gen = torch.cat([torch.cat([Z, F], -1), torch.cat([G, Z], -1)], -2)
    T = torch.linalg.matrix_exp(gen * (1j * t))
    Phi_r = medium_matrix(Kx, Ky, EPS_REF)
    M = torch.linalg.solve(Phi_r, prec.mm(T, Phi_r))
    S = transfer_to_s(M, prec)
    for _ in range(int(math.log2(n_slabs))):
        S = star(S, S, prec)
    Phi_a = medium_matrix(Kx, Ky, 1.0)
    Phi_g = medium_matrix(Kx, Ky, eps_g)
    top = transfer_to_s(torch.linalg.solve(Phi_r, Phi_a), prec)
    bottom = transfer_to_s(torch.linalg.solve(Phi_g, Phi_r), prec)
    return star(star(top, S, prec), bottom, prec), Kx, Ky


def cell_amplitudes(orders, xyrra, Lx, Ly, h, eps_p, eps_g, lam, ux, uy,
                    c_inc, nv=True, prec=FULL):
    """Transmitted (glass) and reflected (air) amplitudes s11 c, s21 c of
    the incident amplitudes ``c_inc`` (2N, K)."""
    S, Kx, Ky = cell_smatrix(orders, xyrra, Lx, Ly, h, eps_p, eps_g, lam, ux,
                             uy, nv=nv, prec=prec)
    c = torch.as_tensor(c_inc).to(device=S[0].device, dtype=S[0].dtype)
    return prec.mm(S[0], c), prec.mm(S[2], c), Kx, Ky


def incident_sp(ux: float, uy: float, pol: str):
    """(c_y, c_x) of a unit-E s or p plane wave in air travelling (ux, uy,
    +uz); normal incidence takes S4's special case."""
    kap2 = ux * ux + uy * uy
    uz = math.sqrt(max(1.0 - kap2, 0.0))
    if kap2 < 1e-18:
        return (-1.0, 0.0) if pol == "s" else (0.0, 1.0)
    kap = math.sqrt(kap2)
    if pol == "s":
        return (-ux * uz / kap, -uy * uz / kap)
    return (-uy / kap, ux / kap)
