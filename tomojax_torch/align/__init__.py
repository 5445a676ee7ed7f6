from tomojax_torch.align.cc import com_align

__all__ = ["com_align"]
