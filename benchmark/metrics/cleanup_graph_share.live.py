"""The share (%) of the live step's cleanups that replayed a captured CUDA
graph: the untraced window's increase of the program's
``cleanup_graph_replays`` counter over its ``cleanup`` spans
(``vbr_tpu_torch.utils.profiling``; in the live cell each lies under a
``step``, a redone frame's under its ``redo``).  None where the window
holds no such counter (a program without the graph, or no card)."""

from benchmark import spans


def read(run):
    w = spans.window(run)
    if w is None or not w[1].get("cleanup_graph_replays"):
        return None
    calls = sum(1 for s in w[0] if s.name == "cleanup")
    return 100.0 * w[1]["cleanup_graph_replays"] / calls if calls else None
