"""GAT's attention kernels' share of their roofline: the least bytes of the
traced steps' ``gat_attention`` launches (``flops/gat.py``
``attention_bytes`` at each step's valid slots, counted by
``paths/gat_device.py``) at the H100's 3.35 TB/s, over the summed time of
the kernels whose name holds ``gat_attention`` (forward, backward and the
backward's reduction), in %.  ``None`` where no such kernel ran or the
run's path counts no bytes."""
from ..harness import PEAK_HBM_BYTES_PER_S


def read(ctx):
    t = ctx.trace.kernel_seconds("gat_attention")
    moved = getattr(ctx, "gat_attention_bytes", None)
    if not t or not moved:
        return None
    return 100.0 * moved / PEAK_HBM_BYTES_PER_S / t
