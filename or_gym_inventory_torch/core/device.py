"""Device resolution shared by every entry point of the port.

Entry points take ``device=None``, which means the GPU. Without one they
raise: nothing drops quietly to the CPU. Callers that want the CPU (the CPU
tests do) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
