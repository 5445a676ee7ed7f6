"""State carried across from tomojax, as numpy arrays.

The caller turns tomojax objects into plain fields first (e.g.
``dataclasses.asdict(geom)`` for a Geometry, ``jax.tree.map(np.asarray,
views)`` for Views or a CGLSState); the functions here build the port's
objects from those fields, so both packages can be fed the same state
without this package importing JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.core.geometry import Geometry, Views


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def geometry(fields) -> Geometry:
    """Geometry from a mapping of tomojax's Geometry fields."""
    return Geometry(**{k: fields[k] for k in (
        "n_proj", "vox_shape", "det_shape", "vox_pix", "det_pix",
        "step_size", "vox_ds")})


def views(arrays, *, device=None) -> Views:
    """Views from the leaves of tomojax's Views as numpy arrays (a
    NamedTuple or a mapping), keeping their dtype."""
    return Views(**{name: torch.as_tensor(np.array(_field(arrays, name)),
                                          device=device)
                    for name in ("phi", "alpha", "beta", "t", "cor")})


def cgls_state(s, *, device=None) -> CGLSState:
    """CGLSState from tomojax's CGLSState leaves as numpy arrays."""
    # imported here: the solver imports the operators, which import this
    # package (for its profiling spans)
    from tomojax_torch.recon.cgls import CGLSState

    def t(name):
        return torch.as_tensor(np.array(_field(s, name)), device=device)

    return CGLSState(x=t("x"), r=t("r"), p=t("p"), gamma=t("gamma"),
                     k=int(_field(s, "k")), stop=int(_field(s, "stop")),
                     reinit_iter=int(_field(s, "reinit_iter")),
                     conv_prev=t("conv_prev"))
