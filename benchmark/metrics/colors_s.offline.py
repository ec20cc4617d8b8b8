"""Host seconds per ``process_frames_offline`` call in its ``colors``
spans: the ``lin_idx`` download and the per-frame host colour gathers
(``carve_blocked.frame_colors_host``). The program's own spans
(``vbr_tpu_torch.utils.profiling``), summed over the untraced window and
divided by its calls (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("colors",), "offline")
