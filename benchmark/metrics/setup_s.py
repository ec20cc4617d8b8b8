"""Set-up seconds: the program's construction, background training, table
builds and kernel loads, and warm-up of the cell's own shapes (host
clock, ending in a synchronise)."""


def read(run):
    return run.setup_s
