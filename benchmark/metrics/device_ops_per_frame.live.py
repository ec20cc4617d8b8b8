"""Device operations (kernels, copies and fills in the profiler's trace)
per frame of the traced window."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    f = run.trace_record.get("frames")
    if f is None or not len(f):
        return None
    return len(run.trace.device) / len(f)
