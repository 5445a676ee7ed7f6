"""Per-view affine ray map shared by the projector families.

Counterpart of ``tomojax.core.fast_projector``; so far only
:func:`view_affine` is ported (the rest of the fast family is ROADMAP
Queue 1 item 16). It is written in torch ops, so autograd and
``torch.func`` differentiate it in the view parameters.
"""

from __future__ import annotations

import torch

from tomojax_torch.core.geometry import Geometry
from tomojax_torch.core.rotations import rot_x, rot_y, rot_z


def view_affine(geom: Geometry, phi, alpha, beta, t, cor, dtype=None):
    """Affine map (u, v, j) → sample position, origin-relative.

    ``p = R (s0 + u·du·x̂ + v·dv·ẑ + cor_x·x̂) + R_pa t − origin + j·step·R ŷ``
    with R = R_z R_x R_y (ray path) and R_pa = R_z R_x. Angles may carry
    leading batch dimensions ``S`` (``t`` and ``cor`` then ``S + (3,)``).

    :returns: ``(E, B)``: E of shape ``S + (3, 3)`` with columns
        EU = du·R[:, 0], EV = dv·R[:, 2], ED = step·R[:, 1], and B of
        shape ``S + (3,)``.
    """
    phi = torch.as_tensor(phi, dtype=dtype)
    kw = dict(dtype=phi.dtype, device=phi.device)
    alpha = torch.as_tensor(alpha, **kw)
    beta = torch.as_tensor(beta, **kw)
    t = torch.as_tensor(t, **kw)
    cor = torch.as_tensor(cor, **kw)

    r_pa = rot_z(phi) @ rot_x(alpha)
    R = r_pa @ rot_y(beta)

    su, sv = geom.det_size
    du, dv = geom.det_pix
    sy = geom.vox_size[1]
    s0 = (torch.tensor([-su / 2.0 + 0.5, -sy, -sv / 2.0 + 0.5], **kw)
          + cor[..., :1] * torch.tensor([1.0, 0.0, 0.0], **kw))
    origin = torch.as_tensor(geom.vox_origin_np(), **kw)
    B = ((R @ s0.unsqueeze(-1)).squeeze(-1)
         + (r_pa @ t.unsqueeze(-1)).squeeze(-1) - origin)
    E = torch.stack([du * R[..., :, 0], dv * R[..., :, 2],
                     geom.step_size * R[..., :, 1]], dim=-1)
    return E, B
