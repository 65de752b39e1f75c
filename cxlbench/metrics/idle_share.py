"""Share of the traced window in which nothing ran on the device (the
reader of ``idle_share.<cells>``)."""


def read(run):
    tr = run.devtrace
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
