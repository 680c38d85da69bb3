"""``mfu``: the whole step's share of the card's dense bf16 peak in the
device-bound cell (moves ``train_img_per_s``)."""

from bench_port.trace import mfu as read  # noqa: F401
