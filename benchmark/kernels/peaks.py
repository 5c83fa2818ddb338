"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12  # tensor cores
FP32_OPS_PER_S = 67e12  # off the tensor cores


def nbytes(t, itemsize=None) -> int:
    """Bytes of tensor `t` at `itemsize` bytes an element (its own size
    when None); 0 for None."""
    if t is None:
        return 0
    return t.numel() * (t.element_size() if itemsize is None else itemsize)
