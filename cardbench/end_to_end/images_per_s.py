"""Images answered before the window closed, over the window's length."""


def read(run):
    return run.completed_in_window / run.seconds
