"""Answers completed in the window over the window's seconds (host clock)."""


def read(run):
    return run.answered_in_window / run.seconds
