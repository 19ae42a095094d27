"""The share of the traced steps' wall time in which no kernel or copy ran
on the device."""


def read(summary, ctx):
    if summary.window_s <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
