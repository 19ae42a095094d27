"""The highest reading of the CUDA allocator's peak that the program's
``step`` span took as it closed, in GB. None where the run recorded no
spans."""


def read(summary, ctx):
    peak = getattr(summary, "mem_peak_bytes", 0)
    return peak / 1e9 if peak else None
