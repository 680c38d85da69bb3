"""``step.host_syncs``: synchronising CUDA operations a training step, the
program's ``syncs`` counter of ``trainer.step`` (moves ``train_img_per_s``)."""

from bench_port import spans


def read(t):
    return spans.host_syncs(spans.first_period_rows())
