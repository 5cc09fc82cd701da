"""Device resolution of the port: the card unless the caller asks for the
CPU.  There is no quiet fallback: asking for CUDA without a card raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; ``'cpu'`` (or a CPU ``torch.device``) is
    honoured only when asked for.  Raises when CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the card "
                "unless asked for the CPU (device='cpu', or --platform cpu)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
