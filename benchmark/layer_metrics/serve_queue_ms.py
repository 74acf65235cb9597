"""Mean time from a request's enqueue to its batch's flush, from the
requests' lifecycle marks (``enqueue``, ``coalesce``)."""


def read(ctx):
    ms = ctx["out"]["layer"]["queue_ms"]
    return sum(ms) / len(ms) if ms else None
