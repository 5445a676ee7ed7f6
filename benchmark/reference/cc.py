"""Plain reference of the cross-correlation chain's registrations.

Subpixel phase cross-correlation by the upsampled matrix-multiply DFT
(Guizar-Sicairos, Thurman and Fienup, Opt. Lett. 33, 156 (2008)), with
scikit-image's ``phase_cross_correlation`` conventions: the shift that
registers ``moving`` to ``reference`` (rows, cols); phase normalization;
the coarse peak at the first maximum of |cc|, wrapped past half the
image, rounded to ``1/u``; the refinement over a ``ceil(1.5 u)``² grid of
spacing ``1/u`` centred on it. Images are shifted by the Fourier
translation theorem. Batched over a leading axis; computed in the dtype of
the input (float64 for the reference). This file imports nothing of the
program.
"""

from __future__ import annotations

import math

import torch


def _freq(n, like):
    return torch.fft.fftfreq(n, dtype=torch.float64,
                             device=like.device).to(like.real.dtype)


def _first_argmax2(a):
    flat = a.flatten(-2).argmax(-1)
    return flat // a.shape[-1], flat % a.shape[-1]


def register(reference, moving, u: int):
    """``(..., 2)`` shifts registering ``moving`` to ``reference``."""
    real = reference.dtype
    prod = torch.fft.fft2(reference) * torch.fft.fft2(moving).conj()
    eps = torch.finfo(real).eps
    prod = prod / prod.abs().clamp_min(100.0 * eps)
    cc = torch.fft.ifft2(prod)
    rows, cols = _first_argmax2(cc.abs())
    ny, nx = cc.shape[-2:]
    shift = torch.stack([torch.where(rows > ny // 2, rows - ny, rows),
                         torch.where(cols > nx // 2, cols - nx, cols)],
                        -1).to(real)
    shift = torch.round(shift * u) / u
    region = math.ceil(1.5 * u)
    centre = float(region // 2)
    offset = centre - shift * u
    grid = torch.arange(region, dtype=real, device=prod.device)

    def kernel(n, off):
        pts = (grid - off[..., None])[..., :, None] * _freq(n, prod) / u
        return torch.exp(-2j * math.pi * pts)

    up = (kernel(ny, offset[..., 0]) @ prod.conj()
          @ kernel(nx, offset[..., 1]).transpose(-1, -2))
    r, c = _first_argmax2(up.abs())
    return shift + (torch.stack([r, c], -1).to(real) - centre) / u


def fourier_shift(img, shift):
    """Images ``(..., ny, nx)`` shifted by ``shift (..., 2)``."""
    ky = _freq(img.shape[-2], img)
    kx = _freq(img.shape[-1], img)
    arg = (shift[..., 0, None, None] * ky[:, None]
           + shift[..., 1, None, None] * kx[None, :])
    return torch.fft.ifft2(torch.fft.fft2(img)
                           * torch.exp(-2j * math.pi * arg)).real


def chain(projections, u: int, rnd=None):
    """The sequential chain: each view registered to its shifted
    predecessor and shifted; ``rnd`` (a dtype) rounds every image the
    chain reads. :returns: ``(offsets (n, 2), aligned (n, ny, nx))``."""
    p = projections if rnd is None else projections.to(rnd).to(
        projections.dtype)
    prev = p[0]
    offsets = [torch.zeros(2, dtype=p.dtype, device=p.device)]
    aligned = [prev]
    for img in p[1:]:
        s = register(prev, img, u)
        prev = fourier_shift(img, s)
        if rnd is not None:
            prev = prev.to(rnd).to(p.dtype)
        offsets.append(s)
        aligned.append(prev)
    return torch.stack(offsets), torch.stack(aligned)
