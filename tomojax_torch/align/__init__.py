from tomojax_torch.align.cc import (
    phase_cross_correlation, cor_flipping, cross_correlation_chain,
    com_align, moment_match, align_to_reprojection,
    cross_correlation_filtered, fourier_shift,
)
from tomojax_torch.align.pipeline import (AlignState, align_reconstruct,
                                          align_reconstruct_cv,
                                          frozen_polish, load_checkpoint,
                                          save_checkpoint)
from tomojax_torch.align.refine import (PARAM_SETS, RefineResult,
                                        alignment_cost, alignment_cost_grad,
                                        gradient_descent_view, refine_view,
                                        refine_views)
from tomojax_torch.align.slab_refine import refine_views_slab

__all__ = ["phase_cross_correlation", "cor_flipping",
           "cross_correlation_chain", "com_align", "moment_match",
           "align_to_reprojection", "cross_correlation_filtered",
           "fourier_shift", "AlignState", "align_reconstruct",
           "align_reconstruct_cv", "frozen_polish", "load_checkpoint",
           "save_checkpoint", "PARAM_SETS", "RefineResult",
           "alignment_cost", "alignment_cost_grad", "gradient_descent_view",
           "refine_view", "refine_views", "refine_views_slab"]
