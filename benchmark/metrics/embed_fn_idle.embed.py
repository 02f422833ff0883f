"""The share of the traced window, in percent, in which the device was
idle while the dispatching thread was inside the embed function (a
``vpr.embed`` span of the port or one of its parts): the part of
``idle.embed`` that the embed function's own host work leaves."""

from benchmark.metrics._program import idle_share


def read(reading):
    return idle_share(reading, "vpr.embed",
                      lambda name: name == "vpr.embed"
                      or name.startswith("vpr.embed."))
