"""Activation rematerialisation of a training block (``compute.remat``).

JAX ``nn.remat`` of a block: the forward keeps the block's inputs only,
and the backward runs the block's forward again to rebuild what its
gradient needs.  The JAX SaShiMi policy also keeps each block's
``conv_out`` and ``glu_out`` where its TPU kernels tag them, and keeps
nothing on its CPU route; here nothing is kept, so every forward kernel
of a block runs twice a training step (its launch count doubles)."""

from __future__ import annotations

import torch.utils.checkpoint


def checkpointed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a non-reentrant activation checkpoint.
    The blocks draw no random numbers, so no RNG state is stashed."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)
