"""The port's host time a request outside its waits on the device, in ms:
the time of the port's root spans less that of its wait spans, from
``cuzk_tpu_torch.utils.trace.totals()`` for the traced window, over the
requests completed.  None where the program has no such spans, or the
window recorded none."""


def read(view):
    try:
        from cuzk_tpu_torch.utils import trace
    except ImportError:
        return None
    totals = trace.totals()
    if not totals["requests"] or view.requests <= 0:
        return None
    return 1e3 * (totals["root_s"] - totals["wait_s"]) / view.requests
