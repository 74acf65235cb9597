"""The allocator's peak over the window (reset at its start), in GiB."""


def read(ctx):
    return ctx["out"]["layer"]["peak_window_bytes"] / 2 ** 30
