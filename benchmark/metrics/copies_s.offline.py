"""Host seconds per ``process_frames_offline`` call in its ``pad`` and
``concat`` spans: the host copies that pad the video to whole chunks and
join the chunks' occupancy. The program's own spans
(``vbr_tpu_torch.utils.profiling``), summed over the untraced window and
divided by its calls (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("pad", "concat"), "offline")
