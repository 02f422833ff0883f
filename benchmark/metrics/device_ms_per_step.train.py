"""The device's busy time per train step, in ms: the seconds in which an
operation ran on the device in the traced window over the steps stepped
there. The host paces the step, so ``train_utt_per_s`` spreads with the
host's speed from run to run; this reads only the device's share of the
step, steady from run to run, and shows a change to the device's work."""


def read(reading):
    trace, c = reading.get("trace"), reading.get("counters", {})
    if trace is None or not c.get("steps"):
        return None
    return 1000.0 * trace.busy_s / c["steps"]
