"""The rows that the port's digit<->limb conversions in PyTorch's kernels
handled a request, in % of the rows the request's trees hold
(``view.work["rows"]``): the counters the program names in
``cuzk_tpu_torch.field.fr.ROW_COUNTERS``, as
``cuzk_tpu_torch.utils.trace.totals()`` reports them for the traced
window, over the requests completed.  None where the program names no
such counters, the window recorded no root span, or the work counts no
rows."""


def read(view):
    try:
        from cuzk_tpu_torch.field import fr
        from cuzk_tpu_torch.utils import trace
    except ImportError:
        return None
    names = getattr(fr, "ROW_COUNTERS", None)
    rows = view.work.get("rows")
    totals = trace.totals()
    if names is None or not rows or not totals["requests"] or view.requests <= 0:
        return None
    converted = sum(totals["counters"].get(name, 0) for name in names)
    return 100.0 * converted / view.requests / rows
