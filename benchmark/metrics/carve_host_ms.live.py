"""Host ms per frame in the live step's ``carve`` spans:
``carve_blocked.carve_blocked``: block activity and kernel K1. The
program's own spans (``vbr_tpu_torch.utils.profiling``) that are children
of a ``step`` span, summed over the untraced window and divided by its
frames (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("carve",), "step", 1e3)
