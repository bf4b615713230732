"""The device's idle time by program span: every stretch of a traced window
in which the device runs nothing, put down to the innermost of the port's
spans open on the host over it, and the per-layer readings made from that.

The port makes each of its spans and phases a ``record_function`` range
while a profiler records (transductive_clip_tpu_torch/core/profiling.py),
and nothing else in the benchmark's process opens one, so the profiler's
CPU-side user annotations are the port's spans. ``trace.spans`` leaves
them out of the busy time and the operations; here they name the idle
time.

``idle_by_span(annotations(prof), trace.spans(prof))`` is the reduction.
``trace.traced`` does not call it yet: a record carries its result under
``trace["idle_by_span"]`` once ``traced`` adds it there, and until then
the readers below read nothing."""

from __future__ import annotations

from .trace import union

# the spans whose idle time the zs cells' metrics read, one metric each;
# every other span and no span at all make a sixth
TASK_SPANS = ("newton", "em.step", "host_wait", "upload", "class_pools")
# the spans whose idle time the extraction cells' metrics read (the two
# issue spans in one metric); every other span and none make the third
EXTRACT_SPANS = ("extract.softmax", "extract.encode", "extract.first_issue")


def annotations(prof):
    """[(name, start us, end us)] of the profiler's CPU-side user
    annotations (the port's spans), read from its raw kineto events as
    ``trace.spans`` reads the others. A device-side copy of an annotation
    is not read."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if (annotation is None or not annotation()
                or e.device_type() != DeviceType.CPU):
            continue
        start = e.start_ns() / 1e3
        out.append((e.name(), start, start + e.duration_ns() / 1e3))
    return out


def idle_by_span(ranges, events):
    """{span name: idle seconds} of a traced window.

    ``events``: (name, on the device, start us, end us) as ``trace.spans``
    gives them; ``ranges``: (name, start us, end us) as ``annotations``
    gives them. The window runs from the first of either to the last of
    either, so its idle head and tail count. The idle time is the window
    less the union of the device's intervals; each idle stretch is cut
    where a range opens or closes, and each piece goes to the range that
    covers it and started last (the port's spans nest on the host thread
    that runs the work, so that is the innermost; the shorter on a tie), or
    to "" where none is open. Every range's name is a key, with 0 where it
    covered no idle time; the values sum to the window less the busy
    time."""
    out = {name: 0.0 for name, _, _ in ranges}
    out[""] = 0.0
    if not events and not ranges:
        return out
    lo = min([e[2] for e in events] + [r[1] for r in ranges])
    hi = max([e[3] for e in events] + [r[2] for r in ranges])
    busy = union((s, t) for _, on_dev, s, t in events if on_dev and t > s)
    marks = []
    at = lo
    for s, t in busy:
        if s > at:
            marks += [(at, -1, True), (s, -1, False)]
        at = max(at, t)
    if hi > at:
        marks += [(at, -1, True), (hi, -1, False)]
    for i, (_, s, t) in enumerate(ranges):
        if t > s:
            marks += [(s, i, True), (t, i, False)]
    marks.sort(key=lambda m: m[0])
    covering = {}          # open range -> (start, -end): the max is inner
    inner, idle, prev = "", False, lo
    for time, i, opens in marks:
        if idle and time > prev:
            out[inner] += (time - prev) * 1e-6
        prev = time
        if i < 0:
            idle = opens
            continue
        if opens:
            covering[i] = (ranges[i][1], -ranges[i][2])
        else:
            covering.pop(i, None)
        inner = (ranges[max(covering, key=covering.get)][0] if covering
                 else "")
    return out


def idle_ms(rec, spans, reads, units):
    """The untraced work's idle time (``untraced_s`` less the traced
    ``busy_s``, what ``idle_share`` reads) in the share of the traced idle
    time whose innermost span is one of ``reads`` (None: every span outside
    ``spans``, and no span), over ``units`` (the traced batches or passes),
    in ms. The profiler slows the host, so the traced idle time overstates
    the untraced one: it gives the shares, the untraced time the amount.
    The readings of one cell over ``spans`` and the rest sum to its idle
    time per unit. None where the record has no idle time by span, or
    where the traced stretch opened not every span of ``spans`` (a program
    without them)."""
    tr = rec.get("trace") or {}
    by_span = tr.get("idle_by_span")
    if (by_span is None or not units or not rec.get("untraced_s")
            or any(s not in by_span for s in spans)):
        return None
    traced_idle = sum(by_span.values())
    if traced_idle <= 0:
        return 0.0
    part = sum(v for k, v in by_span.items()
               if (k in reads if reads is not None else k not in spans))
    untraced_idle = rec["untraced_s"] - tr["busy_s"]
    return 1e3 * untraced_idle * part / traced_idle / units
