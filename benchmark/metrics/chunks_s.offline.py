"""Host seconds per ``process_frames_offline`` call in its ``chunk``
spans: one chunk of the chunk loop each (upload, mask stages, K2, K4 and
the chunk's downloads). The program's own spans
(``vbr_tpu_torch.utils.profiling``), summed over the untraced window and
divided by its calls (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("chunk",), "offline")
