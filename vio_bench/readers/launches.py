"""Kernel launches the host issued (runtime and driver launch calls in the
trace) over the traced steps, a step."""


def read(summary, ctx):
    if summary.launches <= 0 or summary.steps <= 0:
        return None
    return summary.launches / summary.steps
