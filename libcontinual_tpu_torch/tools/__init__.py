"""Measurement tools of the port: the counterparts of ``tools/bench_attention.py``
and ``tools/exp_flash_kernel.py``, run as
``python -m libcontinual_tpu_torch.tools.<name>``."""
