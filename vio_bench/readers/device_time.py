"""Device time of all kernels of the traced steps, in ms a step."""


def read(summary, ctx):
    if summary.kernel_s <= 0 or summary.steps <= 0:
        return None
    return summary.kernel_s * 1e3 / summary.steps
