"""A program op's share of its roofline: the least time its computation
needs at the cell's shapes and rows (``vio_bench/roofline.py``) over the
mean device time of the kernels launched under the op, a call. The
kernels are found by the op they were launched under, not by name, so the
share reads the same work whatever implements the op."""

from vio_bench.roofline import call_dims, kernel_bound


def read(summary, ctx, op: str):
    seconds, calls = summary.op_calls(op)
    if calls == 0 or seconds <= 0:
        return None
    dims = call_dims(op, ctx["filter"], ctx["block_ticks"])
    bound_ms, _ = kernel_bound(op, dims, ctx["dtype"], B=ctx["rows"])
    return 100.0 * bound_ms / (seconds * 1e3 / calls)
