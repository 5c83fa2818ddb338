"""K3, multi-scale deformable attention sampling of the pixel decoder
(`csrc/deform_attn.cu`)."""

from benchmark.kernels.peaks import FP32_OPS_PER_S, nbytes

OP = "deform_attn"
PATTERNS = ("deform_attn_",)
PEAK_OPS_PER_S = FP32_OPS_PER_S  # the bilinear weights are fp32


def work(call, itemsize):
    """(bytes, operations): the value map, the fp32 locations and weights
    and the output once; four taps a sample, a multiply-add a channel
    each."""
    value, loc, aw = call["value"], call["loc"], call["aw"]
    b, lq, heads, n_lv, npts, _ = loc.shape
    d = value.shape[3]
    out = b * lq * heads * d * itemsize
    return (nbytes(value, itemsize) + nbytes(loc, 4) + nbytes(aw, 4) + out,
            8 * b * lq * heads * n_lv * npts * d)
