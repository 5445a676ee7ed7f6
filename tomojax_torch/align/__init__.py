from tomojax_torch.align.cc import com_align, moment_match
from tomojax_torch.align.pipeline import (AlignState, align_reconstruct,
                                          load_checkpoint, save_checkpoint)
from tomojax_torch.align.refine import PARAM_SETS, RefineResult
from tomojax_torch.align.slab_refine import refine_views_slab

__all__ = ["com_align", "moment_match", "AlignState", "align_reconstruct",
           "load_checkpoint", "save_checkpoint", "PARAM_SETS",
           "RefineResult", "refine_views_slab"]
