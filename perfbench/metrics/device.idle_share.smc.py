"""1 - the union of device operation intervals over the traced window, in
%, in an SMC cell's traced run."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
