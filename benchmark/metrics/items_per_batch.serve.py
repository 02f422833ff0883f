"""Requests per micro-batch in the window: ``MicroBatcher.items`` over
``MicroBatcher.batches``, both counted from the window's start."""


def read(reading):
    c = reading.get("counters", {})
    if not c.get("batches"):
        return None
    return c["items"] / c["batches"]
