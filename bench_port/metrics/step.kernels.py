"""``step.kernels``: CUDA kernels a training step, counted in the profiled
sub-window of the device-bound cell (moves ``train_img_per_s``)."""

from bench_port.trace import kernels_a_step as read  # noqa: F401
