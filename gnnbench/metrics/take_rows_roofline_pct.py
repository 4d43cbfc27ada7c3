"""``take_rows``'s share of its roofline: the least bytes of the traced
steps' layer-0 fetches (each id, each output row, each distinct source row
once; the benchmark's count from its own sampler) at the H100's 3.35 TB/s,
over the summed time of the ``assemble_kernel`` launches, in %."""
from ..harness import PEAK_HBM_BYTES_PER_S


def read(ctx):
    t = ctx.trace.kernel_seconds("assemble_kernel")
    if not t or not ctx.take_rows_bytes:
        return None
    return 100.0 * ctx.take_rows_bytes / PEAK_HBM_BYTES_PER_S / t
