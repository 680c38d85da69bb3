"""Method registry. Importing this package registers the ported methods
(L2P, DualPrompt, CodaPrompt, DAP)."""

from libcontinual_tpu_torch.methods import dap, prompt_methods  # noqa: F401
