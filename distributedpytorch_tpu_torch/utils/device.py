"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device on a machine without one
    raises — the port never falls back to the CPU unasked; pass
    ``device="cpu"`` for a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available — the port runs on the card by "
            "default; pass device='cpu' (CLI: --device cpu) for a CPU run"
        )
    return dev
