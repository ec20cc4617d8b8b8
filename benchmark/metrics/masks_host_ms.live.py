"""Host ms per frame in the live step's ``masks`` spans: the mask stage's
head: HSV, frozen MOG apply, pre-morphology. The program's own spans
(``vbr_tpu_torch.utils.profiling``) that are children of a ``step`` span,
summed over the untraced window and divided by its frames (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("masks",), "step", 1e3)
