"""Device time of the program's own kernels per request, in ms."""


def read(view):
    if view.requests <= 0 or view.program_kernel_s <= 0:
        return None
    return 1e3 * view.program_kernel_s / view.requests
