"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`, with "cuda" pinned to the current card;
    raises when a CUDA device is asked for and none is present (nothing
    carries on on the CPU unless asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pqt_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
