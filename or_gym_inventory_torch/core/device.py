"""Device resolution shared by every entry point of the port.

Entry points take ``device=None``, which means the GPU. Without one they
raise: nothing drops quietly to the CPU. Callers that want the CPU (the CPU
tests do) pass ``device="cpu"``. ``synchronize`` and ``to_numpy`` are the
host's two ways of waiting for the device: before a clock read, and when a
result crosses to NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from or_gym_inventory_torch.core.struct import tree_leaves


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def synchronize(tree) -> None:
    """Wait for the device work behind the CUDA tensors in ``tree`` (a
    tensor or a nested dict, list, tuple or dataclass of them)."""
    if any(x.is_cuda for x in tree_leaves(tree) if isinstance(x, torch.Tensor)):
        torch.cuda.synchronize()


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """``x`` on the host as a NumPy array (waits for the work behind it)."""
    return x.detach().cpu().numpy()
