"""Shift pre-alignment and moment matching (counterpart of
``tomojax.align.cc``).

- :func:`phase_cross_correlation` — subpixel registration by the
  upsampled matrix-multiply DFT (Guizar-Sicairos et al., Opt. Lett. 33,
  2008), with skimage's sign convention; :func:`cor_flipping` — the
  centre of rotation from a 0°/180° pair.
- :func:`cross_correlation_chain` — each view registered to its already
  aligned predecessor, shifted by Fourier translation; a host loop over
  the views with no host sync per view.
- :func:`cross_correlation_filtered` — the integer-pixel chain with a
  sin² band-pass and window; each view is rolled by index arithmetic on
  the device (no host sync per view).
- :func:`align_to_reprojection` — registration against reprojections of
  a coarse SIRT reconstruction, out-of-fold (default) or self-consistent.
- :func:`com_align` — per-view (tx, tz) from the sinogram centre of mass;
  :func:`moment_match` — first-moment corrections against reprojections.

The registration functions take one image pair or a leading batch of
them. Array inputs go to ``device`` (default ``cuda``); tensors keep
theirs. The upsampled DFT is computed in the data's real dtype.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tomojax_torch.core.operators import make_operator, resolve_device
from tomojax_torch.recon.sirt import sirt
from tomojax_torch.utils import profiling

# align_to_reprojection's default number of folds (clamped to n_proj // 2)
DEFAULT_FOLDS = 4
_DEFAULT = object()


def _tensor(x, device=None):
    """``x`` as a tensor: a tensor keeps its device, anything else goes to
    ``resolve_device(device)``."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.array(x), device=resolve_device(device))


def _fftfreq(n, like):
    """``fftfreq(n)`` computed in float64 (numpy's values) and cast to
    ``like``'s real dtype, on its device (no host copy)."""
    return torch.fft.fftfreq(n, dtype=torch.float64,
                             device=like.device).to(like.real.dtype)


def _argmax2(a):
    """(row, col) of the first maximum over the last two axes of ``a``."""
    flat = a.flatten(-2).argmax(-1)
    return flat // a.shape[-1], flat % a.shape[-1]


def fourier_shift(img, shift, *, device=None):
    """Shift 2-D images (..., ny, nx) by (possibly fractional) ``shift``
    (..., 2) via the Fourier translation theorem; exact for integer shifts
    (≡ ``torch.roll``)."""
    img = _tensor(img, device)
    shift = torch.as_tensor(shift, device=img.device)
    ky = _fftfreq(img.shape[-2], img)
    kx = _fftfreq(img.shape[-1], img)
    arg = (shift[..., 0, None, None] * ky[:, None]
           + shift[..., 1, None, None] * kx[None, :])
    phase = torch.exp(-2j * math.pi * arg)
    return torch.fft.ifft2(torch.fft.fft2(img) * phase).real


def _upsampled_dft(data, region_size, upsample_factor, offsets):
    """Matrix-multiply DFT of ``data`` (..., ny, nx) over a ``region_size``²
    grid of spacing ``1/upsample_factor`` placed by ``offsets`` (..., 2):
    two small complex matmuls instead of a zero-padded FFT."""
    real = data.real.dtype

    def kernel(n, offset):
        grid = torch.arange(region_size, dtype=real, device=data.device)
        samples = ((grid - offset[..., None])[..., :, None]
                   * _fftfreq(n, data) / upsample_factor)
        return torch.exp(-2j * math.pi * samples)

    ker_y = kernel(data.shape[-2], offsets[..., 0])      # (..., r, ny)
    ker_x = kernel(data.shape[-1], offsets[..., 1])      # (..., r, nx)
    return torch.einsum("...ry,...yx,...sx->...rs", ker_y, data, ker_x)


def phase_cross_correlation(reference, moving, upsample_factor: int = 1,
                            normalization: str | None = "phase", *,
                            device=None):
    """Subpixel translation registering ``moving`` to ``reference``.

    :returns: ``shift (..., 2)`` such that shifting ``moving`` by
        ``shift`` (rows, cols) aligns it with ``reference`` (skimage's
        convention), in the images' real dtype.
    """
    reference = _tensor(reference, device)
    moving = _tensor(moving, reference.device)
    with profiling.span("cc.correlate"):
        ref_f = torch.fft.fft2(reference)
        prod = ref_f * torch.fft.fft2(moving).conj()
        real = prod.real.dtype
        if normalization == "phase":
            eps = torch.finfo(real).eps
            prod = prod / prod.abs().clamp_min(100.0 * eps)

        cc = torch.fft.ifft2(prod)
        shift = torch.stack([torch.where(m > n // 2, m - n, m) for m, n in
                             zip(_argmax2(cc.abs()), cc.shape[-2:])],
                            dim=-1).to(real)
    if upsample_factor == 1:
        return shift

    # refine on an upsampled local DFT grid (Guizar-Sicairos matrix DFT)
    with profiling.span("cc.refine"):
        u = float(upsample_factor)
        shift = torch.round(shift * u) / u
        region = math.ceil(1.5 * u)
        dftshift = float(region // 2)
        offsets = dftshift - shift * u
        cc_up = _upsampled_dft(prod.conj(), region, u, offsets)
        maxima_up = torch.stack(_argmax2(cc_up.abs()), dim=-1).to(real)
        return shift + (maxima_up - dftshift) / u


def cor_flipping(proj_0, proj_180, upsample_factor: int = 16, *,
                 device=None):
    """Centre-of-rotation offset from projections 180° apart: register the
    0° view against the left-right flipped 180° view and return the
    horizontal (x) shift."""
    proj_0 = _tensor(proj_0, device)
    flipped = torch.flip(_tensor(proj_180, proj_0.device), dims=(-1,))
    shift = phase_cross_correlation(proj_0, flipped,
                                    upsample_factor=upsample_factor)
    return shift[..., 1]


def cross_correlation_chain(projections, upsample_factor: int = 100, *,
                            device=None):
    """Sequentially register each view to its aligned predecessor.

    :returns: ``(offsets (n_proj, 2), aligned (n_proj, ny, nx))``: view i
        is registered to the *shifted* view i−1 and shifted by Fourier
        translation.
    """
    p = _tensor(projections, device)
    with profiling.span("cc.chain"):
        prev = p[0]
        shifts, aligned = [], [prev]
        for img in p[1:]:
            with profiling.span("cc.view"):
                s = phase_cross_correlation(prev, img,
                                            upsample_factor=upsample_factor)
                with profiling.span("cc.shift"):
                    prev = fourier_shift(img, s)
            profiling.count("cc.views")
            shifts.append(s)
            aligned.append(prev)
        offsets = torch.cat([torch.zeros((1, 2), dtype=p.real.dtype,
                                         device=p.device),
                             torch.stack(shifts).reshape(-1, 2)])
        return offsets, torch.stack(aligned)


def _roll2(img, s0, s1):
    """``img`` rolled by the device scalars ``s0`` (axis 0) and ``s1``
    (axis 1), as ``torch.roll`` with those shifts."""
    n0, n1 = img.shape
    i0 = torch.remainder(torch.arange(n0, device=img.device) - s0, n0)
    i1 = torch.remainder(torch.arange(n1, device=img.device) - s1, n1)
    return img.index_select(0, i0).index_select(1, i1)


def cross_correlation_filtered(projections, cutoff: int = 4, *,
                               device=None):
    """Integer-pixel chain alignment with a sin² band-pass in k-space and a
    sin² real-space window; per pair the shift is the argmax of the
    filtered cross-correlation, applied by rolling, and shifts beyond half
    the image are unwrapped at the end. As in tomojax, defined for square
    images.

    :returns: ``(offsets (n_proj, 2), aligned (n_proj, nx, nz))``.
    """
    p = _tensor(projections, device)
    n_proj, nx, nz = p.shape
    kw = dict(dtype=p.dtype, device=p.device)
    KX, KZ = torch.meshgrid(_fftfreq(nx, p), _fftfreq(nz, p), indexing="xy")
    abs_k = torch.sqrt(KX**2 + KZ**2)
    filter_k = torch.where(abs_k <= 0.5 / cutoff,
                           torch.sin(2 * math.pi * cutoff * abs_k) ** 2, 0.0)
    X, Z = torch.meshgrid(torch.linspace(1, nx, nx, **kw),
                          torch.linspace(1, nz, nz, **kw), indexing="xy")
    filter_r = (torch.sin(math.pi * X / nx) * torch.sin(math.pi * Z / nz)
                ) ** 2

    def spectrum(img):
        return torch.fft.fft2((img - img.mean()) * filter_r)

    prev = p[0]
    shifts, aligned = [], [prev]
    for img in p[1:]:
        xcor = torch.fft.ifft2(spectrum(img).conj() * spectrum(prev)
                               * filter_k).abs()
        s0, s1 = _argmax2(xcor)
        prev = _roll2(img, s0, s1)
        shifts.append(torch.stack([s0, s1]).to(p.dtype))
        aligned.append(prev)
    offsets = torch.cat([torch.zeros((1, 2), **kw),
                         torch.stack(shifts).reshape(-1, 2)])
    # unwrap circular shifts beyond half the image
    offsets[:, 0] = torch.where(offsets[:, 0] > nz / 2, offsets[:, 0] - nz,
                                offsets[:, 0])
    offsets[:, 1] = torch.where(offsets[:, 1] > nx / 2, offsets[:, 1] - nx,
                                offsets[:, 1])
    return offsets, torch.stack(aligned)


def _add_shifts(views, shifts):
    """Views with ``shifts`` (n, 2) added to (tx, tz), cast to t's dtype
    first (as JAX's ``.at[].add``)."""
    t = views.t.clone()
    t[:, 0] += shifts[:, 0].to(t)
    t[:, 2] += shifts[:, 1].to(t)
    return dataclasses.replace(views, t=t)


def align_to_reprojection(projections, geom, views, *, rounds: int = 2,
                          recon_iters: int = 20, upsample_factor: int = 20,
                          family: str = "slab_plane", folds=_DEFAULT,
                          dtype=torch.float32, device=None):
    """Translational pre-alignment against reprojections of a coarse
    SIRT reconstruction (classical projection matching, out-of-fold).

    With ``folds=K`` each view is registered to the reprojection of a
    reconstruction built without its own data: the views are split into
    K interleaved folds and each fold is phase-correlated against its
    complement's reconstruction, with unit gain. The default is
    ``DEFAULT_FOLDS`` (4), clamped to ``n_proj // 2`` for fewer than 8
    views; an explicit ``folds`` outside ``[2, n_proj // 2]`` raises.

    ``folds=None`` keeps the self-consistent variant: one shared
    reconstruction and a secant estimate of the gain.

    :returns: (views with updated ``t``, (n_proj, 2) last-round shifts).
    """
    meas = _tensor(projections, device)
    device = meas.device
    n = views.n_proj
    nu, nv = geom.det_shape
    meas = meas.to(dtype).reshape(n, nu, nv)

    def pcc(synth, ref):
        return phase_cross_correlation(synth, ref,
                                       upsample_factor=upsample_factor)

    def reconstruct(g, vw, b):
        op = make_operator(g, vw, family=family, dtype=dtype, device=device)
        return op, sirt(op, b.reshape(vw.n_proj, -1), niter=recon_iters,
                        positivity=True).x

    if folds is _DEFAULT:
        folds = min(DEFAULT_FOLDS, n // 2)
    if folds is not None:
        K = int(folds)
        if not 2 <= K <= n // 2:
            raise ValueError(f"folds={folds} must be in [2, n_proj//2]")
        fold_ix = [np.arange(k, n, K) for k in range(K)]
        comp_ix = [np.setdiff1d(np.arange(n), ix) for ix in fold_ix]
        shifts = torch.zeros((n, 2), dtype=dtype, device=device)
        for _ in range(rounds):
            sh = torch.zeros((n, 2), dtype=dtype, device=device)
            for ix, cix in zip(fold_ix, comp_ix):
                _, rec = reconstruct(dataclasses.replace(geom,
                                                         n_proj=len(cix)),
                                     views.take(cix), meas[cix])
                fop = make_operator(dataclasses.replace(geom,
                                                        n_proj=len(ix)),
                                    views.take(ix), family=family,
                                    dtype=dtype, device=device)
                synth = fop.A(rec).reshape(len(ix), nu, nv)
                sh[ix] = pcc(synth, meas[ix])
            shifts = sh
            # pcc(synth, meas) tracks +(t_true − t_est) in (u, v) =
            # (tx, tz) at full strength (out-of-fold): unit gain
            views = _add_shifts(views, shifts)
        return views, shifts

    gain = 1.8
    shifts = torch.zeros((n, 2), dtype=dtype, device=device)
    prev = None
    for _ in range(rounds):
        op, rec = reconstruct(geom, views, meas)
        shifts = pcc(op.A(rec).reshape(n, nu, nv), meas)
        if prev is not None:
            # secant gain estimate with a conservative cap
            rho = float((shifts * prev).sum()
                        / (prev * prev).sum().clamp_min(1e-12))
            atten = max((1.0 - rho) / gain, 1e-3)
            gain = float(np.clip(1.0 / atten, 1.0, 8.0))
        prev = shifts
        views = _add_shifts(views, gain * shifts)
    return views, shifts


def com_align(projections, geom, phi, dtype=torch.float32, *, device=None):
    """Per-view (tx, tz) from the sinogram center-of-mass (Helgason–Ludwig
    first-moment) consistency condition.

    In detector coordinates ``u_com_i = Cx cos(phi_i) + Cy sin(phi_i) −
    tx_i`` and ``v_com_i = Cz − tz_i``: tx is observable up to its
    projection onto span{1, cos φ, sin φ}, so u_com is regressed on that
    span and the negated residual returned; v_com keeps plain mean
    removal (assuming zero-mean jitter).

    :param device: torch device (default: the projections' device if they
        are a tensor, else ``cuda``).
    :returns: (n_proj, 2) tensor of per-view (tx, tz) estimates.
    """
    if device is None and torch.is_tensor(projections):
        device = projections.device
    device = resolve_device(device)
    phi = np.asarray(phi, np.float64)
    n = len(phi)
    nu, nv = geom.det_shape
    p = torch.as_tensor(projections, device=device).to(dtype).reshape(
        n, nu, nv).clamp_min(0.0)
    kw = dict(dtype=dtype, device=p.device)
    mass = p.sum(dim=(1, 2))
    u = torch.arange(nu, **kw).reshape(1, nu, 1)
    v = torch.arange(nv, **kw).reshape(1, 1, nv)
    u_com = (p * u).sum(dim=(1, 2)) / mass
    v_com = (p * v).sum(dim=(1, 2)) / mass
    # least-squares projector onto span{1, cos, sin}, in float64 on the host
    basis = np.stack([np.ones_like(phi), np.cos(phi), np.sin(phi)], 1)
    proj_mat = torch.as_tensor(basis @ np.linalg.pinv(basis), **kw)
    tx = proj_mat @ u_com - u_com
    tz = v_com.mean() - v_com
    return torch.stack([tx, tz], dim=1)


def moment_match(meas, synth, det_shape):
    """Per-view (Δtx, Δtz) additive corrections from sinogram first-moment
    (center-of-mass) matching against reprojections.

    For any volume the reprojection's detector center of mass moves
    rigidly by −t in the co-rotating detector frame, so ``Δt = com(synth)
    − com(meas)`` measures each view's translation error up to the gauge
    (tx: {cos φ, sin φ}, tz: {const}), however much misalignment the
    reconstruction absorbed. Coordinates are centred on the detector and
    the sums taken in float64 on the tensors' device.

    :param meas: measured sinogram ``(n_proj, n_det)`` or ``(n_proj, nu,
        nv)``.
    :param synth: reprojection of the current (volume, θ), same shape.
    :returns: ``(n_proj, 2)`` float64 tensor of (Δtx, Δtz) to ADD to the
        current (tx, tz) estimates; zero for views with no mass.
    """
    nu, nv = det_shape
    m = torch.as_tensor(meas).to(torch.float64).reshape(-1, nu, nv)
    s = torch.as_tensor(synth).to(torch.float64).reshape(-1, nu, nv)
    kw = dict(dtype=torch.float64, device=m.device)
    u = (torch.arange(nu, **kw) - (nu - 1) / 2.0)[None, :, None]
    v = (torch.arange(nv, **kw) - (nv - 1) / 2.0)[None, None, :]

    def com(p):
        mass = p.sum(dim=(1, 2))
        mass = torch.where(mass.abs() > 1e-12, mass, 1.0)
        return (p * u).sum(dim=(1, 2)) / mass, (p * v).sum(dim=(1, 2)) / mass

    mu, mv = com(m)
    su, sv = com(s)
    ok = (m.sum(dim=(1, 2)) > 1e-12) & (s.sum(dim=(1, 2)) > 1e-12)
    return torch.stack([torch.where(ok, su - mu, 0.0),
                        torch.where(ok, sv - mv, 0.0)], dim=1)
