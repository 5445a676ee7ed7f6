from tomojax_torch.utils import config, io, interop

__all__ = ["config", "io", "interop"]
