"""K2, attention of the SD UNet and VAE (`csrc/flash_attention.cu`):
softmax(Q K^T / sqrt(d)) V, non-causal, unmasked."""

from benchmark.kernels.peaks import BF16_OPS_PER_S, nbytes

OP = "attention"
PATTERNS = ("flash_",)
PEAK_OPS_PER_S = BF16_OPS_PER_S


def work(call, itemsize):
    """(bytes, operations): Q, K, V and the output once; two matrix
    products of 2 * Tq * Tk * d each a head."""
    q, k, v = call["q"], call["k"], call["v"]
    b, h, tq, d = q.shape
    return (nbytes(q, itemsize) + nbytes(k, itemsize) + nbytes(v, itemsize)
            + nbytes(q, itemsize)), 4 * b * h * tq * k.shape[2] * d
