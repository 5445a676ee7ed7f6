"""tomojax_torch — the PyTorch/CUDA port of tomojax for NVIDIA Hopper.

Same layout and names as ``tomojax`` so each module's counterpart is easy to
find, written in PyTorch's idiom: plain functions on tensors, an explicit
``device=`` argument, explicit ``torch.Generator``s, and a
``torch.autograd.Function`` around each hand-written kernel pair.

- ``core``    : geometry, rotations, phantoms, the exact ray-driven
                projector, the slab-marching projector (plane and arc
                quadrature), the fast multi-pass projector and the
                matrix-free operator.
- ``kernels`` : hand-written CUDA kernels for ``sm_90a`` and their plain
                PyTorch versions (a CPU tensor takes the plain version).
- ``recon``   : CGLS, SIRT, Tikhonov, lasso (ISTA/FISTA), FISTA-TV with
                its TV prox, and the line searches, as host loops.
- ``align``   : COM and FFT cross-correlation pre-alignment, moment
                matching, the batched slab LM, fast-family gradient
                descent and the alternating driver.
- ``tools``   : the BASELINE config drivers and measurement scripts.
- ``utils``   : config dataclasses, dataset IO, and interop with tomojax's
                state (as numpy arrays).

This package imports neither ``jax`` nor ``tomojax``.
"""

__version__ = "0.1.0"

from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core import rotations
from tomojax_torch.core import phantom

__all__ = ["Geometry", "Views", "rotations", "phantom", "__version__"]
