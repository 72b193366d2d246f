"""Mean share of the batch's slots live in each scheduler step of the
window (``BatchScheduler.slots`` read between steps), in %."""


def read(record):
    occ = record.get("slot_occupancy")
    return 100.0 * sum(occ) / len(occ) if occ else None
