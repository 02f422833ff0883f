"""The FCM kernel's share of its roofline (its four launches together):
the bf16 bound of every batch's valid frames (``work.fcm_work``) over the
device time of ``fcm_launch_kernel`` in the traced window."""

from benchmark.metrics._roofline import share
from benchmark.work import fcm_work, valid_frames


def read(reading):
    return share(reading, "fcm_launch_kernel",
                 lambda lens, padded: fcm_work(valid_frames(lens, padded)), "bf16")
