"""Host time for a decode-block call to return, before its tokens are read
back, over the block's steps, in ms: the wrapper around the scheduler's
decode block, summed over the blocks of the measured window (from its
first step to its close; the lead-in before it and the profiled steps after
it are not counted), read in the traced run."""


def read(record):
    s, n = record.get("enqueue_s"), record.get("enqueue_steps")
    if record.get("platform") != "cuda" or not n:
        return None
    return 1e3 * s / n
