"""The device's idle share in training: 1 - the union of its operations'
intervals over the profiled stretch's window, in %."""
PROFILE = True


def read(t):
    if not t.window_s or t.busy_s is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
