"""Host ms per frame in the live step's ``overflow_wait`` spans, where the
host reads the cleanup's overflow bits and so waits for the device to
finish the frame's work queued before them: the program's own spans
(``vbr_tpu_torch.utils.profiling``) under a ``step`` span, summed over the
untraced window and divided by its frames (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("overflow_wait",), "step", 1e3)
