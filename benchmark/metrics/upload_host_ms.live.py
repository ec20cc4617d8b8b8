"""Host ms per frame in the live step's ``upload`` spans:
``VisualHull._frames``: pinning the frame and queueing its copy to the
device. The program's own spans (``vbr_tpu_torch.utils.profiling``) that
are children of a ``step`` span, summed over the untraced window and
divided by its frames (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("upload",), "step", 1e3)
