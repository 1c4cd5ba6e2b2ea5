"""Host rebuilds per request over the measured window, from the
program's counters: weight packs (``kernels.packs``), resize tables
(``resize.tables_built``) and kernel libraries loaded
(``kernels.libs_loaded``).  A cache that holds reads 0 for the tables
and libraries."""

KEYS = ("kernels.packs", "resize.tables_built", "kernels.libs_loaded")


def read(summary):
    counts = summary.get("counts")
    n = summary.get("main_requests") or 0
    if counts is None or n <= 0:
        return None
    return sum(counts.get(k, 0) for k in KEYS) / n
