"""Share of the prompt tokens the engine took in during the window whose
KV it found resident (``EngineStats.prefix_cached_tokens``) rather than
prefilled (``prefill_tokens``), in percent."""


def read(w):
    hit = w.stats["prefix_cached_tokens"]
    total = hit + w.stats["prefill_tokens"]
    return 100.0 * hit / total if total else None
