"""Mean of the program's ``serve/stage`` span per batch (the rows copied
into the pinned staging buffer and the copy to the card enqueued)."""


def read(ctx):
    ms = [1e3 * (s.t1 - s.t0) for s in ctx["spans"] if s.name == "serve/stage"]
    return sum(ms) / len(ms) if ms else None
