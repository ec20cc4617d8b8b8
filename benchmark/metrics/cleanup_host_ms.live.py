"""Host ms per frame in the live step's ``cleanup`` spans:
``ccl.clean_masks_batched``: kernel K2 and the run tables' statistics. The
program's own spans (``vbr_tpu_torch.utils.profiling``) that are children
of a ``step`` span, summed over the untraced window and divided by its
frames (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("cleanup",), "step", 1e3)
