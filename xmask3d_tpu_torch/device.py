"""Device choice for the port's entry points, and device constants.

Entry points run on the GPU unless the caller asks for the CPU; without a
GPU and without that request they raise rather than fall back.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the current CUDA device (under torchrun `cuda:LOCAL_RANK`,
    which `parallel/mesh.py` `init_distributed` makes current); "cpu" must
    be asked for. A CUDA device without an index is the current one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_CONSTANTS: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}


def device_constant(key: Hashable, device: torch.device,
                    build: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The tensor `build()` makes on the host, copied to `device` once and
    kept; `key` names its values (what it is, its shapes and parameters).
    A forward pass takes its constants from here, so it makes no
    host-to-device copy: the first eager pass fills the cache, and a CUDA
    graph captured after it only reads the cached tensors (a pageable copy
    is not allowed during capture). Callers must not write to the result."""
    k = (key, torch.device(device))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = build().to(device)
    return t


def category_columns(n: int, categories: Sequence[int], device: torch.device) -> torch.Tensor:
    """(n,) bool: which of n class columns are in `categories`."""
    cats = tuple(int(c) for c in categories)
    return device_constant(
        ("category_columns", n, cats), device,
        lambda: torch.isin(torch.arange(n), torch.tensor(cats, dtype=torch.int64)))
