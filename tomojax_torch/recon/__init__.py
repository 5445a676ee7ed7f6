from tomojax_torch.recon.cgls import (cgls, cgls_init, cgls_steps,
                                      CGLSResult, CGLSState)
from tomojax_torch.recon.sirt import sirt, SIRTResult
from tomojax_torch.recon.tikhonov import tikhonov_gd, TikhonovResult
from tomojax_torch.recon.lasso import lasso_ista, lasso_fista, LassoResult
from tomojax_torch.recon.fista_tv import fista_tv, FistaTVResult
from tomojax_torch.recon import tv

__all__ = ["cgls", "cgls_init", "cgls_steps", "CGLSResult", "CGLSState",
           "sirt", "SIRTResult", "tikhonov_gd", "TikhonovResult",
           "lasso_ista", "lasso_fista", "LassoResult", "fista_tv",
           "FistaTVResult", "tv"]
