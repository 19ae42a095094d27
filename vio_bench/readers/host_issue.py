"""The host's time to issue one batched step: the program's own inclusive
host time of its ``step`` span, a call, with tracing on and no profiler
running. None where the run recorded no spans."""


def read(summary, ctx):
    return getattr(summary, "host_issue_ms", None)
