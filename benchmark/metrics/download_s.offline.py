"""Host seconds per ``process_frames_offline`` call in its ``download``
spans: a chunk's occupancy and overflow bits copied to pageable host
memory, the host waiting for the chunk's device work. The program's own
spans (``vbr_tpu_torch.utils.profiling``), summed over the untraced window
and divided by its calls (host clock)."""

from benchmark import spans


def read(run):
    return spans.per_unit(run, ("download",), "chunk")
