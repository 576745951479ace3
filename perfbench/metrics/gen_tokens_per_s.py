"""Every token the engine emitted inside the window, over its seconds."""


def read(w):
    return w.generated / w.seconds if w.seconds > 0 else None
