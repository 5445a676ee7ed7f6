"""Typed experiment configuration — a copy of ``tomojax.utils.config``
(importing it would import JAX). Same fields and defaults, so a config
json drives both packages; the port supports a subset of the values
(``cli.py`` names what raises)."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class GeometryConfig:
    n_proj: int = 90
    vox_shape: tuple = (64, 64, 64)
    det_shape: tuple = (64, 64)
    vox_pix: tuple = (1.0, 1.0, 1.0)
    det_pix: tuple = (1.0, 1.0)
    step_size: float = 1.0

    def build(self):
        from tomojax_torch.core.geometry import Geometry
        return Geometry(n_proj=self.n_proj, vox_shape=tuple(self.vox_shape),
                        det_shape=tuple(self.det_shape),
                        vox_pix=tuple(self.vox_pix),
                        det_pix=tuple(self.det_pix),
                        step_size=self.step_size)


@dataclasses.dataclass
class SolverConfig:
    method: str = "sirt"          # sirt | cgls | tikhonov | lasso | fista_tv
    niter: int = 100
    positivity: bool = False
    reg_param: float = 1.0        # tikhonov / lasso
    hyper: Optional[float] = None  # fista_tv step (None → auto Lipschitz)
    beta_tv: float = 1.0
    niter_tv: int = 20
    family: str = "ray"           # ray | voxel
    dtype: str = "float32"


@dataclasses.dataclass
class AlignConfig:
    outer_iters: int = 10
    param_set: str = "xzab"
    refine_iters: int = 12
    recon_iters: int = 100
    recon: str = "sirt"
    positivity: bool = True
    bound_trans: float = 3.0      # ±px (reference align_rigid.py:48)
    bound_angle: float = 0.02     # ±rad
    pre_align_cc: bool = False    # FFT cross-correlation pre-alignment
    checkpoint_dir: Optional[str] = None
    # production-scale knobs (see align.pipeline.align_reconstruct)
    family: str = "ray"           # recon family: ray | fast | voxel |
    #                               slab | slab_plane
    refine_method: str = "lm"     # lm | lm_slab | gd_fast
    recon_chunk: Optional[int] = None    # solver iters per device program
    refine_chunk: Optional[int] = None   # views per refinement program
    accel_period: Optional[int] = None   # Aitken-accelerate every N outers
    moment_period: Optional[int] = 1     # COM moment-match every N outers
    debias_period: Optional[int] = None  # exact-family defect correction
    recon_prec: str = "f32x2"            # recon stage's slab kernel tier:
    #                                      f32x2 | bf16 (each apply within
    #                                      3e-3 of fp32; refinement fp32)


@dataclasses.dataclass
class SimulateConfig:
    phantom: str = "shepp"        # shepp | random
    seed: int = 0
    max_shift_px: float = 2.0     # reference generate_data.py:22-23
    max_angle_deg: float = 1.0    # reference generate_data.py:17-18
    family: str = "ray"           # data-generating projector family
    #                               (slab_plane for >=256^3 — the exact
    #                               family takes hours there)


@dataclasses.dataclass
class ExperimentConfig:
    geometry: GeometryConfig = dataclasses.field(default_factory=GeometryConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    align: AlignConfig = dataclasses.field(default_factory=AlignConfig)
    simulate: SimulateConfig = dataclasses.field(default_factory=SimulateConfig)

    def to_json(self, path=None):
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, path_or_str):
        try:
            d = json.loads(path_or_str)
        except (json.JSONDecodeError, ValueError):
            with open(path_or_str) as f:
                d = json.load(f)
        return cls(
            geometry=GeometryConfig(**d.get("geometry", {})),
            solver=SolverConfig(**d.get("solver", {})),
            align=AlignConfig(**d.get("align", {})),
            simulate=SimulateConfig(**d.get("simulate", {})),
        )
