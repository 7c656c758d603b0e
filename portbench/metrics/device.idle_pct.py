"""The device (the H100): the share of the traced window, from the first traced
request's send to the last one's reply, in which no kernel ran, in percent."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
