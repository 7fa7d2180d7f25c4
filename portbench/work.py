"""Work counts and the peaks they are held against.

The operations and bytes of an operation are worked out here from its
shapes, whatever implements it: a roofline share is the least time the card
could take for the work over the time the kernels took.  Each input byte is
counted read once and each output byte written once.

Peaks: one NVIDIA H100 SXM at its full 700 W limit (NVIDIA's data sheet):
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

import math

PEAK_F32 = 67e12              # flop/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
C64 = 8                       # bytes of one complex64 entry


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time for the work: the larger of the flops at the float32
    peak and the bytes at the memory rate."""
    return max(flops / PEAK_F32, nbytes / HBM_BYTES_PER_S) * 1e3


def ps_split(d: int, n_poly: int = 3):
    """Paterson-Stockmeyer chunk size s and chunk count r minimizing
    (s-1) + n_poly (r-1) matrix products for n_poly series of degree d."""
    s_best, cost_best = 1, None
    for s in range(1, d + 2):
        r = -(-(d + 1) // s)
        cost = (s - 1) + n_poly * (r - 1)
        if cost_best is None or cost < cost_best:
            s_best, cost_best = s, cost
    return s_best, -(-(d + 1) // s_best)


def taylor_work(n: int, B: int, n_terms: int):
    """Flops and bytes of the thin-slab Taylor factors of B pairs (F, G) of
    n x n complex matrices with an n_terms series: the products of the
    shared-power evaluation (1 for Y = F G, s - 1 powers, 3 (r - 1) Horner
    steps, 4 wrapper products; 8 n^3 flops each), the coefficient x power
    terms of the chunks (4 flops an entry) and the Horner adds (2 flops an
    entry); F and G read, the four factors written, and the (B, 3,
    n_terms + 1) float32 coefficient table read."""
    s, r = ps_split(n_terms)
    products = 1 + (s - 1) + 3 * (r - 1) + 4
    power_terms = sum(1 for _ in range(3) for k in range(n_terms + 1)
                      if k % s)
    flops = (products * 8 * n ** 3
             + (4 * power_terms + 2 * 3 * (r - 1)) * n * n) * B
    nbytes = 6 * C64 * n * n * B + B * 3 * (n_terms + 1) * 4
    return flops, nbytes


def inverse_work(n: int, B: int):
    """Flops and bytes of B complex n x n inverses: n^3 complex
    multiply-adds (8 n^3 flops) each, the matrix read and its inverse
    written."""
    return 8 * n ** 3 * B, 2 * C64 * n * n * B


def cell_solve_inverses(N: int, n_slabs: int, nv: bool = True):
    """The inverses one NV cell solve needs, as (size, count): at N, E^-1
    and, with NV, <<1/eps>>^-1; at 2N, the slab's transfer -> scattering
    conversion, one per doubling, the layer | glass star and the air
    interface's star."""
    return [(N, 2 if nv else 1), (2 * N, 3 + int(math.log2(n_slabs)))]
