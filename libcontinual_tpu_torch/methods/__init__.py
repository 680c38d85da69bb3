"""Method registry. Importing this package registers the ported methods
(L2P, DualPrompt, CodaPrompt, DAP, MOE_ADAPTER4CL, RAPF)."""

from libcontinual_tpu_torch.methods import clip_methods, dap, prompt_methods  # noqa: F401
