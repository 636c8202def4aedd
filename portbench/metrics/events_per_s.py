"""End to end: input events a second whose send returned and whose rows
all reached the callback, over the window's seconds (the first send to
the last send's return)."""


def read(run):
    return run.events / run.window_s
