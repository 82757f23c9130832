"""The device's idle share of the traced PGD window: 1 - the union of its
operations' intervals over the window's length, in %."""


def read(ctx):
    if ctx["kind"] != "dagger" or ctx["trace"].busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s / ctx["trace"].window_s)
