"""The arithmetic the per-layer metric readers share: a span's host time a
step and its kernels' device time a step, a kernel's share of its
roofline, the device's idle share and the step's share of the float32
peak."""

from __future__ import annotations

from perfbench.roofline.peaks import PEAK_FP32_FLOPS, bound_s


def span_ms(ctx, names):
    """Host milliseconds a window step spent in the spans ``names``."""
    if not ctx.steps or not any(ctx.spans.calls[n] for n in names):
        return None
    return sum(ctx.spans.seconds[n] for n in names) / ctx.steps * 1e3


def span_device_ms(ctx, names):
    """Device milliseconds a traced step of the kernels launched inside the
    spans ``names``."""
    if not ctx.trace_steps or not any(n in ctx.trace.span_s for n in names):
        return None
    return sum(ctx.trace.span_s.get(n, 0.0) for n in names) \
        / ctx.trace_steps * 1e3


def roofline_share(ctx, kernel):
    """Percent: the least time the card could take for the work of the
    kernel's captured calls (``kernel.work``) over the device time of its
    launches in the traced window (``kernel.KERNELS``)."""
    calls = ctx.captures.get(kernel.CAPTURE, [])
    device_s = ctx.trace.kernel_seconds(kernel.KERNELS)
    if not calls or device_s <= 0:
        return None
    need = sum(bound_s(*kernel.work(args)) for args in calls)
    return 100.0 * need / device_s


def idle_share(ctx):
    """Percent of a step in which the device ran nothing: the traced
    steps' device-busy seconds a step over the measured window's seconds a
    step.  (The profiler's host overhead stretches the traced steps
    themselves several times on this launch-bound path, so their own
    window would overstate the idle share.)"""
    if not ctx.steps or ctx.trace.busy_s <= 0:
        return None
    busy = ctx.trace.busy_s / ctx.trace_steps
    return 100.0 * max(0.0, 1.0 - busy / (ctx.window_s / ctx.steps))


def counted_flops(ctx, kernels) -> int:
    """The counted operations of the traced steps' calls of ``kernels``
    (``kernel.work``); a kernel counts where its launches are in the
    trace."""
    return sum(sum(k.work(args)[0] for args in ctx.captures.get(k.CAPTURE, []))
               for k in kernels if ctx.trace.kernel_seconds(k.KERNELS) > 0)


def step_mfu(ctx, kernels):
    """Percent of the card's float32 peak that the counted operations of
    the traced steps reach in as many steps of the measured window (the
    profiler stretches the traced steps themselves, see
    :func:`idle_share`)."""
    flops = counted_flops(ctx, kernels)
    if not flops or not ctx.steps or ctx.trace.busy_s <= 0:
        return None
    seconds = ctx.trace_steps * ctx.window_s / ctx.steps
    return 100.0 * flops / (seconds * PEAK_FP32_FLOPS)


def device_mfu(ctx, kernels):
    """Percent of the card's float32 peak that the counted operations of
    the traced steps reach in the seconds the device was busy in them: the
    step's share of the peak on the device's time, which bounds the
    kernels' roofline shares where the cell's end-to-end metric is taken
    from the device."""
    flops = counted_flops(ctx, kernels)
    if not flops or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * flops / (ctx.trace.busy_s * PEAK_FP32_FLOPS)
