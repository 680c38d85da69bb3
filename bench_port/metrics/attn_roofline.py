"""``attn_roofline``: the port's attention kernels' share of their roofline in
the device-bound cell (moves ``train_img_per_s``)."""

from bench_port.trace import attention_roofline as read  # noqa: F401
