"""The device (the H100) while the server's generate handler runs: the share of the
traced requests' ``handler`` spans in which no kernel ran, in percent. The host's
gaps between the denoise loop's launches, the text path and the JPEG encode are in
it; the reply's streaming, which follows the handler, is not."""


def read(run):
    if run.trace is None:
        return None
    span_s, busy_s = run.trace.busy_within("handler")
    return 100.0 * (1.0 - busy_s / span_s) if span_s > 0 else None
