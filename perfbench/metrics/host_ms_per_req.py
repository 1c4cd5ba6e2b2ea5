"""Host milliseconds per request spent inside the entry's call, from the
call to its return, before any wait: the measured window's host spans,
all of them, as a mean."""


def read(summary):
    spans = summary.get("host_call_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
