"""Prompt tokens the prefix cache supplied over the prompt tokens admitted
in the window, from the engine's ``stats()`` (``KVBlockManager``'s hit and
miss counters, which add up to every admitted prompt)."""


def read(run):
    a, b = run.extra["stats0"], run.extra["stats1"]
    hit = b["kv_hit_tokens"] - a["kv_hit_tokens"]
    miss = b["kv_miss_tokens"] - a["kv_miss_tokens"]
    if hit + miss <= 0:
        return None
    return 100.0 * hit / (hit + miss)
