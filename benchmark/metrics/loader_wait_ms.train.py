"""Host ms a step waits on ``Trainer.train_loader`` in the window, from
the harness's span around ``next()``: all waits over their count."""


def read(reading):
    times = reading.get("spans", {}).get("loader_wait")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
