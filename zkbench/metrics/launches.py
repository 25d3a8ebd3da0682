"""The port's kernel launches a request: the change of
``ops.poseidon_cuda.launch_counts`` over the traced window, as
``cuzk_tpu_torch.utils.trace.totals()`` reports it, over the requests
completed.  None where the program has no such totals, or the window
recorded no root span."""


def read(view):
    try:
        from cuzk_tpu_torch.utils import trace
    except ImportError:
        return None
    totals = trace.totals()
    if not totals["requests"] or view.requests <= 0:
        return None
    launches = sum(n for name, n in totals["counters"].items()
                   if name.startswith("launch."))
    return launches / view.requests
