"""Method registry. Importing this package registers the ported methods
(L2P so far)."""

from libcontinual_tpu_torch.methods import prompt_methods  # noqa: F401
