"""Mean host wall ms of ``Predictor.predict_batch`` in the window, from the
harness's span around the instance's method: all calls, over their
count."""


def read(reading):
    times = reading.get("spans", {}).get("predict_batch")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
