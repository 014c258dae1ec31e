"""The head-dim rule shared by the port's four attention kernels (the
flash forward, the two backward sweeps and the paged decode).

The kernels are instantiated at head_dim 64, 128 and 192: every multiple
of 64 is a whole number of 128-byte TMA swizzle boxes of bf16. On CUDA
tensors a wrapper zero-pads any other head_dim up to the next instance
and slices its output back. Zero columns are exact: they add nothing to
q·k, give zero output columns and zero gradient columns. The softmax
scale stays the TRUE head_dim's, so a caller that pads passes
``sm_scale``. The JAX reference pads to a multiple of 128 instead
(``repro.kernels.ops.flash_attention``, ``paged_attention_pallas``);
160 pads to 192 here where it pads to 256 there.
"""
from __future__ import annotations

import torch.nn.functional as F

#: head dims the CUDA attention kernels are instantiated for
HEAD_DIMS = (64, 128, 192)


def padded_head_dim(D: int) -> int:
    """The instance a head_dim of ``D`` runs at: the smallest of
    :data:`HEAD_DIMS` that is >= D. Raises ``ValueError`` above the
    largest."""
    for h in HEAD_DIMS:
        if D <= h:
            return h
    raise ValueError(f"head_dim {D} is larger than the attention kernels' "
                     f"largest instance: they are instantiated at head_dim "
                     f"{HEAD_DIMS} and zero-pad up to the next one")


def pad_head_dim(x, D: int):
    """``x`` zero-padded along its last dim to ``D`` (``x`` itself when it
    is already that wide). Raises where ``x`` is wider than ``D``."""
    extra = D - x.shape[-1]
    if extra < 0:
        raise ValueError(f"head_dim {x.shape[-1]} does not pad to {D}")
    return F.pad(x, (0, extra)) if extra else x
