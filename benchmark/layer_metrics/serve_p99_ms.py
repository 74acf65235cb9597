"""The 99th percentile of the requests' latencies, each from its scheduled
send to when the benchmark holds its embedding (a request never answered
counts as infinite), over the requests due before the profiled
sub-window."""


def read(ctx):
    return ctx["out"]["layer"]["p99_ms"]
