"""Decode graphs captured inside the window, over every tenant (0 when the
warm-up captured every key the window uses)."""


def read(run):
    return run.record.captures_in_window
