"""Method registry. Importing this package registers the ported methods
(L2P, DualPrompt, CodaPrompt, DAP, MOE_ADAPTER4CL, RAPF, Finetune, ICarl,
EWC, LWF, WA, LUCIR, bic, DER)."""

from libcontinual_tpu_torch.methods import (  # noqa: F401
    bic, clip_methods, dap, der, ewc, finetune, icarl, lucir, lwf, prompt_methods, wa)
