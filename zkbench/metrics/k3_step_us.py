"""K3's device time a serial permutation, in us: the device time of the
program's own kernels in the traced window over the ``k3.steps`` the port
counted there (each K3 launch adds h x ceil(arity / 2), the permutations
one proof runs in series), as ``cuzk_tpu_torch.utils.trace.totals()``
reports them.  None where the program counts no such steps (before it
counted them, or on a path that launches no K3), or the window holds no
device time of the program."""


def read(view):
    try:
        from cuzk_tpu_torch.utils import trace
    except ImportError:
        return None
    steps = trace.totals()["counters"].get("k3.steps", 0)
    if steps <= 0 or view.program_kernel_s <= 0:
        return None
    return 1e6 * view.program_kernel_s / steps
