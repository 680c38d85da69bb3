"""``device.idle_pct.train``: the device's idle share of the profiled
sub-window in the device-bound cell (moves ``train_img_per_s``)."""

from bench_port.trace import idle_pct as read  # noqa: F401
