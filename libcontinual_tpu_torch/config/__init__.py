from libcontinual_tpu_torch.config.config import Config  # noqa: F401
