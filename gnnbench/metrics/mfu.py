"""The traced steps' model FLOPs (``flops/<arch>.py``) over the traced wall
span times the H100 SXM float32 peak, in %."""
from ..harness import PEAK_F32_FLOPS


def read(ctx):
    return 100.0 * ctx.flops / (ctx.trace.window_s * PEAK_F32_FLOPS) if ctx.flops else None
