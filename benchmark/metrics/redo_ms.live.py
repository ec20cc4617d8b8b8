"""Host ms per redone frame of the live step: the program's ``redo`` spans
under a ``step`` span (``vbr_tpu_torch.utils.profiling``; the host cleanup
of the overflowed cameras and the carve again) summed over the untraced
window, over the window's increase of the program's ``redos`` counter
(host clock)."""

from benchmark import spans


def read(run):
    w = spans.window(run)
    if w is None or not w[1].get("redos"):
        return None
    total = spans.seconds_under(w[0], ("redo",), "step")
    return 1e3 * total / w[1]["redos"] if total > 0 else None
