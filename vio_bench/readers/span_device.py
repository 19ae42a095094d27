"""Device time of the kernels launched under some of the program's spans
(``vio_bench/spans.py``), in ms a step; each kernel counts for the
innermost span around its launch. None where the run recorded no spans."""


def read(summary, ctx, spans: list):
    table = getattr(summary, "spans", None)
    if not table or not any(n in table for n in spans):
        return None
    return sum(table[n]["device_ms"] for n in spans if n in table)
