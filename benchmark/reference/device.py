"""Device constants of the forward: tensors built on the host once and
kept on the device."""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Sequence, Tuple

import torch


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
