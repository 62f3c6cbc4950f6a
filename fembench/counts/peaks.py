"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
700 W), frozen from ``utils/roofline.py:45-47``: HBM bandwidth, and f32 and
f64 outside the tensor cores, the units these kernels run on."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12


def bound_s(ops, nbytes, flops_per_s=F32_FLOPS_PER_S):
    """The least time: ``ops`` at the peak or ``nbytes`` at HBM rate,
    whichever is longer (``utils/roofline.py:90-95``)."""
    return max(ops / flops_per_s, nbytes / HBM_BYTES_PER_S)
