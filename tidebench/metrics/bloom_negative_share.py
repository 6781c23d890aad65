"""Share of the never-written keys probed by ``multi_exists`` that the Bloom
filters turned away (``Metrics.bloom_negative`` over those keys), in %."""


def read(run, cell):
    neg = run["counters"].get("bloom_negative")
    if neg is None or not run["absent_probed"]:
        return None
    return 100.0 * neg / run["absent_probed"]
