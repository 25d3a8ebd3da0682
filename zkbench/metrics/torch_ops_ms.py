"""Device time of everything but the program's own kernels (PyTorch's
kernels, copies and sets) per request, in ms."""


def read(view):
    if view.requests <= 0 or view.busy_s <= 0:
        return None
    return 1e3 * view.other_device_s / view.requests
