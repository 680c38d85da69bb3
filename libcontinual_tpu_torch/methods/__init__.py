"""Method registry. Importing this package registers the ported methods
(L2P, DualPrompt, CodaPrompt, DAP, MOE_ADAPTER4CL, RAPF, Finetune, ICarl)."""

from libcontinual_tpu_torch.methods import (  # noqa: F401
    clip_methods, dap, finetune, icarl, prompt_methods)
