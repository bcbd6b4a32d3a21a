"""dav1d_tpu_torch — the PyTorch/CUDA port of dav1d_tpu, an AV1 decoder.

Host stages (OBU parsing, native Stage A, native intra reconstruction)
are this package's own copies of dav1d_tpu's host code; the pixel work
of inter prediction, residuals and the filter chain runs on a torch
device, as hand-written CUDA kernels (csrc/) on a card.
Key, intra and inter frames decode, with super-res and film grain;
see ROADMAP.md for what is still to port.

Public API mirrors dav1d's push/pull contract
(reference include/dav1d/dav1d.h): see `dav1d_tpu_torch.api.Decoder`.
"""

__version__ = "0.1.0"

from .api import Decoder, Settings  # noqa: F401
