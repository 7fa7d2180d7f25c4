"""Figure of merit as first-class data.

Counterpart of ``metalens_tpu/solver/fom.py`` (the reference's
``grating.lua:188-229`` scoring): per term the cell is excited from air in s
and in p polarization, the target order's transmitted amplitude is read in
S4's block layout (y-block for s, x-block for p; the s amplitude sign-flipped),
inphase terms score |Im(a)| Im(a) / (n_glass cos(theta)), others
|a|^2 / (n_glass cos(theta)), and the FOM is the s/p average, weight-averaged
over terms.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..units import nm


@dataclass(frozen=True)
class FomTerm:
    """One figure-of-merit term.

    wavelength       vacuum wavelength (SI metres)
    weight           relative weight in the weighted mean
    target_order     target diffraction order ox (oy = 0)
    inphase          demand consistent output phase (score the Im component)
    """
    wavelength: float
    weight: float = 1.0
    target_order: int = -1
    inphase: bool = True


DEFAULT_FOM_TERMS = (
    FomTerm(wavelength=580 * nm, weight=0.5, target_order=-1, inphase=True),
    FomTerm(wavelength=450 * nm, weight=0.5, target_order=0, inphase=True),
)


def term_score(amp_s_y: torch.Tensor, amp_p_x: torch.Tensor, n_glass_now,
               cos_theta, inphase: bool) -> torch.Tensor:
    """Score one term from the target-order transmitted amplitudes (complex
    tensors, any batch shape) of the s and p runs."""
    amp_s = -amp_s_y    # s sign flip, grating.lua:208-211
    amp_p = amp_p_x
    if inphase:
        score_s = torch.abs(amp_s.imag) * amp_s.imag
        score_p = torch.abs(amp_p.imag) * amp_p.imag
    else:
        score_s = amp_s.real * amp_s.real + amp_s.imag * amp_s.imag
        score_p = amp_p.real * amp_p.real + amp_p.imag * amp_p.imag
    denom = n_glass_now * cos_theta
    return (score_s / denom + score_p / denom) / 2.0
