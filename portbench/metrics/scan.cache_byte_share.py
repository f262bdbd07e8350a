"""``scan.cache_byte_share``: the share of the bytes the window's runs took
from the differential cache, in %: the scans' column bytes served from the
scan cache and the nodes' output bytes served from the model store, over
those and the bytes read from the object store, summed over every
``RunResult`` of the window.  A node served whole from the model store runs
no scan, so the two caches' bytes do not overlap."""


def read(run):
    cache = sum(e["bytes_from_cache"] + e["bytes_from_model_cache"] for e in run.edits)
    store = sum(e["bytes_from_store"] for e in run.edits)
    if cache + store == 0:
        return None
    return 100.0 * cache / (cache + store)
