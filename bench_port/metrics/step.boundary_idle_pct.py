"""``step.boundary_idle_pct``: the device's idle share between one training
step's end and the next one's start, from the program's ``trainer.step``
spans (moves ``train_img_per_s``)."""

from bench_port import spans


def read(t):
    return spans.boundary_idle_pct(spans.first_period_rows())
