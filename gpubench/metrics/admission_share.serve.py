"""Share of the traced window's wall in which the device ran the admission
chunks' work: the union of kernel intervals inside the device-side ranges of
the ``admission`` spans (the traced run's wrapper around
``BatchScheduler._advance_pending``), over the traced window, in %."""


def read(record):
    tr = record.get("trace")
    if record.get("platform") != "cuda" or not tr or not tr.get("window_s"):
        return None
    s = tr.get("span_busy_s", {}).get("admission")
    return None if s is None else 100.0 * s / tr["window_s"]
