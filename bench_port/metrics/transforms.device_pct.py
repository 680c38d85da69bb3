"""``transforms.device_pct``: the transforms' share of a training step's
device time, from the program's ``step.augment`` and ``trainer.step`` spans
(moves ``train_img_per_s``)."""

from bench_port import spans


def read(t):
    return spans.transforms_device_pct(spans.first_period_rows())
