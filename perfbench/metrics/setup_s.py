"""Process start to the window's start: weights, service, kernel builds
and loads, warm-up and the loop's ramp."""


def read(w):
    return w.setup_s
