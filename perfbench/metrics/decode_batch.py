"""Sequences a decode step carried: ``EngineStats``' decode tokens over
its decode steps, both counted over the window."""


def read(w):
    n = w.stats["decode_steps"]
    return w.stats["decode_tokens"] / n if n else None
