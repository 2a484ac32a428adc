"""Every token generated inside the window over the window's seconds."""


def read(run):
    return run.tokens_in_window() / run.end if run.end > 0 else None
