"""Batched affine row resampling: wrappers, plain versions, autograd.

Counterpart of ``tomojax.kernels.resample``. The function, for view v,
row a and output i = 0..M-1, is

    out[v, a, i] = lerp(row[v, a], offsets[v, a] + slope[v] * i)

with each tap zero outside [0, N). Rows carry a leading view axis and one
or two row axes: ``arr`` is (V, *rows, N), ``offsets`` (V, *rows) and
``slope`` (V,), one slope per view as tomojax has under ``vmap``. Rows may
be strided (a volume shared by every view is ``vol.expand(V, ...)``); the
forward reads rows of contiguous elements, the transpose any strides.
Either output may be laid out in another order than its logical (V,
*rows, W) (``out_order``), so that the next pass reads it as contiguous
rows without a copy; the transpose can also sum its views and add them
into a given tensor (``add_into``).

One wrapper per hand-written kernel entry, each counting its launches in
``.launches``:

- K7 :func:`resample_fwd` — the forward. Replaces tomojax's Pallas
  ``_kernel`` (``tomojax/kernels/resample.py:38``).
- K8 :func:`resample_transpose` — its exact transpose, (V, *rows, M) →
  (V, *rows, N). Replaces ``_kernel_transpose`` (``resample.py:111``).
- K9 :func:`resample_rows_raw` — the non-differentiable direct entry
  (tomojax's ``_resample_rows_pallas_raw``, ``resample.py:356``), served by
  the K7 kernel with a counter of its own.

Both kernels are in ``csrc/resample.cu``, built by ``_build.py`` at first
use. A tensor on the CPU takes the plain PyTorch version beside each
wrapper; a CUDA tensor launches the kernel or raises.

:func:`resample_rows` is the differentiable entry (tomojax's
``resample_rows_pallas``): inputs totalized by :func:`_sanitize`, forward
K7, rows cotangent K8, and the offset and slope cotangents in plain
PyTorch (``resample.py:338-349``), taken only where autograd asks.
"""

from __future__ import annotations

import ctypes

import torch


def _sanitize(offsets, slope, n: int, m_out: int, max_slope: float):
    """Totalize the kernel inputs (tomojax ``_sanitize``): NaN/inf offsets
    go to an out-of-reach sentinel and offsets are clamped to ±bound, the
    slope to ±max_slope. Out-of-range samples are zeros anyway, so this is
    free, and it keeps wild trial parameters (line searches) defined."""
    bound = float(n + max_slope * m_out + 8)
    off = torch.nan_to_num(offsets, nan=bound, posinf=bound,
                           neginf=-bound).clamp(-bound, bound)
    sl = torch.nan_to_num(slope, nan=max_slope, posinf=max_slope,
                          neginf=-max_slope).clamp(-max_slope, max_slope)
    return off.contiguous(), sl.contiguous()


def _positions(offsets, slope, m_out: int):
    """``offsets + slope * i`` → (V, *rows, M), rounded as the kernels
    round it (product, then sum)."""
    i = torch.arange(m_out, dtype=offsets.dtype, device=offsets.device)
    return offsets[..., None] + slope.reshape(-1, *[1] * offsets.dim()) * i


def _taps(arr, kf, n: int):
    """``arr`` at float tap indices ``kf`` (…, M), zero outside [0, n)."""
    ok = (kf >= 0) & (kf <= n - 1)
    idx = torch.where(ok, kf, 0).long()
    vals = torch.gather(arr.expand(*kf.shape[:-1], n), -1, idx)
    return torch.where(ok, vals, 0.0)


def resample_rows_plain(arr, offsets, slope, m_out: int):
    """Plain version of K7: a direct two-tap lerp with per-tap zero masks."""
    n = arr.shape[-1]
    pos = _positions(offsets, slope, m_out)
    kf = torch.floor(pos)
    t = pos - kf
    return (1 - t) * _taps(arr, kf, n) + t * _taps(arr, kf + 1, n)


def resample_rows_transpose_plain(g, offsets, slope, n_data: int, *,
                                  add_into=None):
    """Plain version of K8: autograd's vjp of :func:`resample_rows_plain`
    with respect to the rows; with ``add_into`` summed over the views
    (``.sum(0)``) and added to it."""
    with torch.enable_grad():
        arr = torch.zeros((*offsets.shape, n_data), dtype=g.dtype,
                          device=g.device, requires_grad=True)
        res = resample_rows_plain(arr, offsets, slope, g.shape[-1])
        (abar,) = torch.autograd.grad(res, arr, g)
    if add_into is None:
        return abar
    return add_into.add_(abar.sum(0))


def _inverse(order):
    inv = [0] * len(order)
    for k, d in enumerate(order):
        inv[d] = k
    return inv


def _empty(shape, out_order, device):
    """An uninitialized float32 tensor of logical ``shape`` whose storage
    holds its dims in ``out_order`` (outermost first; None: row-major)."""
    if out_order is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    if sorted(out_order) != list(range(len(shape))):
        raise ValueError(f"out_order {out_order} is not a permutation of "
                         f"the output's {len(shape)} dims")
    buf = torch.empty([shape[d] for d in out_order], dtype=torch.float32,
                      device=device)
    return buf.permute(_inverse(out_order))


def _as_4d(t):
    """(V, *rows, W) with one or two row axes → a (V, R1, R2, W) view."""
    if t.dim() == 3:
        return t.unsqueeze(1)
    if t.dim() != 4:
        raise ValueError(f"expected (V, rows, W) or (V, R1, R2, W), got "
                         f"shape {tuple(t.shape)}")
    return t


def _check(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")


def _storage_order(t):
    """``t``'s dims in storage order, outermost first, when ``t`` is a
    permutation of a contiguous tensor with its last dim innermost; else
    None (row-major)."""
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    if (order == list(range(t.dim())) or order[-1] != t.dim() - 1
            or not t.permute(order).is_contiguous()):
        return None
    return tuple(order)


def _check_operands(rows, offsets, slope, n: int, m: int,
                    contiguous_rows: bool = True):
    """The checks both kernels make; returns ``rows`` as (V, R1, R2, W).
    K7 reads rows of contiguous elements, K8 any strides."""
    for name, t in (("rows", rows), ("offsets", offsets), ("slope", slope)):
        _check(name, t)
    r4 = _as_4d(rows)
    V, R1, R2, _ = r4.shape
    if tuple(offsets.shape) != tuple(rows.shape[:-1]):
        raise ValueError(f"offsets: expected shape {tuple(rows.shape[:-1])},"
                         f" got {tuple(offsets.shape)}")
    if tuple(slope.shape) != (V,):
        raise ValueError(f"slope: expected shape ({V},), got "
                         f"{tuple(slope.shape)}")
    if not (offsets.is_contiguous() and slope.is_contiguous()):
        raise ValueError("offsets and slope must be contiguous")
    if contiguous_rows and r4.shape[-1] > 1 and r4.stride(-1) != 1:
        raise ValueError("each row's elements must be contiguous")
    if V > 65535 or max(R1, R2, n, m) >= 2 ** 31:
        raise ValueError(f"problem too large: V={V}, rows=({R1}, {R2}), "
                         f"N={n}, M={m}")
    return r4


def _call(entry, *args):
    """Call ``entry`` of the kernel library on the current stream of the
    first tensor argument; pointers for tensors, ints as they are."""
    from tomojax_torch.kernels import _build
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_build.load(), entry)(
            *(ctypes.c_void_p(a.data_ptr()) if torch.is_tensor(a) else a
              for a in args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def _launch_fwd(arr, offsets, slope, m: int, out_order=None):
    """Launch K7: rows read strided, the output new in ``out_order``'s
    layout. A transposed output is written along the row axis whose
    output stride is 1; the row axes are swapped for the kernel when that
    is the outer one."""
    r4 = _check_operands(arr, offsets, slope, arr.shape[-1], m)
    V, R1, R2, n = r4.shape
    out = _empty((*arr.shape[:-1], m), out_order, arr.device)
    f4 = offsets.unsqueeze(1) if offsets.dim() == 2 else offsets
    sv, s1, s2, _ = r4.stride()
    fv, f1, f2 = f4.stride()
    ov, o1, o2, oi = _as_4d(out).stride()
    if oi != 1 and o2 != 1:
        if o1 != 1:
            raise ValueError("out_order must keep the resampled axis or a "
                             "row axis innermost")
        R1, R2, s1, s2, f1, f2, o1, o2 = R2, R1, s2, s1, f2, f1, o2, o1
    _call("resample_fwd", r4, offsets, slope, out, V, R1, R2, n, m, sv, s1,
          s2, fv, f1, f2, ov, o1, o2, oi)
    return out


def resample_fwd(arr, offsets, slope, m_out: int, out_order=None):
    """K7: ``arr`` (V, *rows, N), ``offsets`` (V, *rows), ``slope`` (V,) →
    (V, *rows, m_out), stored with its dims in ``out_order`` (outermost
    first; None: row-major). Inputs are taken as they are (no
    sanitizing). On the CPU the plain version's result comes as it is:
    ``out_order`` is a storage detail of the card, and the plain versions
    read any strides."""
    if arr.device.type == "cpu":
        return resample_rows_plain(arr, offsets, slope, m_out)
    out = _launch_fwd(arr, offsets, slope, m_out, out_order)
    resample_fwd.launches += 1
    return out


def _launch_transpose(g, offsets, slope, n: int, out_order, add_into):
    """Launch K8: the cotangent read in its own strides, the output new in
    ``out_order``'s layout, or the views' sum added into ``add_into``
    (output view stride 0). The kernel's inner row
    axis is the output's unit-stride row axis when the output is
    transposed, else the cotangent's when its elements are strided; the
    row axes are swapped for the kernel when that is the outer one."""
    r4 = _check_operands(g, offsets, slope, n, g.shape[-1],
                         contiguous_rows=False)
    V, R1, R2, m = r4.shape
    if add_into is None:
        out = _empty((*g.shape[:-1], n), out_order, g.device)
        ov, o1, o2, on = _as_4d(out).stride()
    else:
        if out_order is not None:
            raise ValueError("give add_into or out_order, not both")
        _check("add_into", add_into)
        shape = (*g.shape[1:-1], n)
        if tuple(add_into.shape) != shape:
            raise ValueError(f"add_into: expected shape {shape}, got "
                             f"{tuple(add_into.shape)}")
        out = add_into
        _, o1, o2, on = _as_4d(out.unsqueeze(0)).stride()
        ov = 0
    gv, g1, g2, gi = r4.stride()
    f4 = offsets.unsqueeze(1) if offsets.dim() == 2 else offsets
    fv, f1, f2 = f4.stride()
    if on != 1 and o2 != 1 and o1 != 1:
        raise ValueError("the output must keep its elements or a row axis "
                         "innermost")
    if (on != 1 and o2 != 1) or (on == 1 and gi != 1 and g2 != 1
                                 and g1 == 1):
        R1, R2, g1, g2, f1, f2, o1, o2 = R2, R1, g2, g1, f2, f1, o2, o1
    _call("resample_transpose", r4, offsets, slope, out, V, R1, R2, n, m, gv,
          g1, g2, gi, fv, f1, f2, ov, o1, o2, on)
    return out


def resample_transpose(g, offsets, slope, n_data: int, out_order=None, *,
                       add_into=None):
    """K8: exact transpose of :func:`resample_fwd` for the rows, ``g`` (V,
    *rows, M) in any strides → (V, *rows, n_data), stored with its dims in
    ``out_order`` (outermost first; None: row-major; the elements or a row
    axis innermost). With ``add_into`` (*rows, n_data), in any strides of
    that kind, the result is summed over the views in order and added into
    it, which is returned. On the CPU the plain version runs, in its own
    layout."""
    if g.device.type == "cpu":
        return resample_rows_transpose_plain(g, offsets, slope, n_data,
                                             add_into=add_into)
    out = _launch_transpose(g, offsets, slope, n_data, out_order, add_into)
    resample_transpose.launches += 1
    return out


def resample_rows_raw(arr, offsets, slope, m_out: int):
    """K9 entry: the non-differentiable direct call (tomojax's
    ``_resample_rows_pallas_raw``, which does not sanitize either). It
    launches the K7 kernel and counts in its own ``.launches``."""
    arr, offsets, slope = arr.detach(), offsets.detach(), slope.detach()
    if arr.device.type == "cpu":
        return resample_rows_plain(arr, offsets, slope, m_out)
    out = _launch_fwd(arr, offsets, slope, m_out)
    resample_rows_raw.launches += 1
    return out


for _fn in (resample_fwd, resample_transpose, resample_rows_raw):
    _fn.launches = 0


def position_cotangents(arr, g, offsets, slope):
    """Offset and slope cotangents of the resample at sanitized inputs
    (tomojax ``_resample_bwd_rule``): ``pc = g · (tap(k+1) − tap(k))``,
    floors and masks piecewise constant. Returns ((V, *rows), (V,))."""
    n, m = arr.shape[-1], g.shape[-1]
    kf = torch.floor(_positions(offsets, slope, m))
    pc = g * (_taps(arr, kf + 1, n) - _taps(arr, kf, n))
    del kf
    i = torch.arange(m, dtype=pc.dtype, device=pc.device)
    return pc.sum(-1), (pc * i).reshape(pc.shape[0], -1).sum(-1)


class _ResampleRows(torch.autograd.Function):
    """K7 forward, K8 rows cotangent, plain position cotangents."""

    @staticmethod
    def forward(ctx, arr, offsets, slope, m_out, max_slope, out_order):
        n = arr.shape[-1]
        off, sl = _sanitize(offsets, slope, n, m_out, max_slope)
        ctx.pos_grad = any(ctx.needs_input_grad[1:3])
        ctx.save_for_backward(arr if ctx.pos_grad else None, off, sl)
        ctx.n = n
        ctx.abar_order = _storage_order(arr)
        return resample_fwd(arr, off, sl, m_out, out_order)

    @staticmethod
    def backward(ctx, g):
        arr, off, sl = ctx.saved_tensors
        abar = obar = sbar = None
        if ctx.needs_input_grad[0]:
            # K8 reads the cotangent in the strides it arrives in (an
            # output stored in another order, a broadcast sum) and stores
            # the rows' cotangent in the layout of the rows, where dense:
            # no copy on either side
            abar = resample_transpose(g, off, sl, ctx.n, ctx.abar_order)
        if ctx.pos_grad:
            obar, sbar = position_cotangents(arr, g, off, sl)
        return abar, obar, sbar, None, None, None


def resample_rows(arr, offsets, slope, m_out: int, max_slope: float,
                  out_order=None):
    """Differentiable batched affine row resample (tomojax's
    ``resample_rows_pallas``).

    :param arr: (V, *rows, N) rows, one or two row axes.
    :param offsets: (V, *rows) start positions.
    :param slope: (V,) per-view slopes; the sanitizer clamps |slope| to
        ``max_slope``. Offsets and slope get cotangents only where autograd
        asks for them.
    :param out_order: the output's dims in storage order, outermost first
        (None: row-major); the resampled axis or a row axis innermost.
    :returns: (V, *rows, m_out), zero outside [0, N).
    """
    slope = torch.as_tensor(slope, dtype=arr.dtype, device=arr.device)
    return _ResampleRows.apply(arr, offsets.to(arr.dtype),
                               slope.reshape(-1), int(m_out),
                               float(max_slope), out_order)


def resample_rows_transpose(g, offsets, slope, n_data: int,
                            max_slope: float, out_order=None, *,
                            add_into=None, interpret: bool = False):
    """Exact transpose of :func:`resample_rows` applied to cotangent rows
    ``g`` (V, *rows, M) → (V, *rows, n_data): sanitize, then K8 (its
    ``out_order`` or ``add_into``). ``interpret`` (tomojax's Pallas
    interpret mode) does nothing: a CPU tensor takes the plain version."""
    off, sl = _sanitize(offsets.to(g.dtype),
                        torch.as_tensor(slope, dtype=g.dtype,
                                        device=g.device).reshape(-1),
                        n_data, g.shape[-1], max_slope)
    return resample_transpose(g, off, sl, n_data, out_order,
                              add_into=add_into)
