"""The program's kernels' share of their roofline, in %: the least time
the card needs for the permutations the cell's requests require
(``roofline.py``, counted from the workload) over the device time of the
program's own kernels in the window."""

from zkbench import roofline


def read(view):
    perms = view.work.get("permutations")
    if not perms or view.program_kernel_s <= 0 or view.requests <= 0:
        return None
    least = max(roofline.multiply_bound_s(perms),
                roofline.bytes_bound_s(view.work.get("rows", 0)))
    return 100.0 * least * view.requests / view.program_kernel_s
