from tomojax_torch.recon.cgls import (cgls, cgls_init, cgls_steps,
                                      CGLSResult, CGLSState)
from tomojax_torch.recon.sirt import sirt, SIRTResult

__all__ = ["cgls", "cgls_init", "cgls_steps", "CGLSResult", "CGLSState",
           "sirt", "SIRTResult"]
