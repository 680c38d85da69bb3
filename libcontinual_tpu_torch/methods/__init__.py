"""Method registry. Importing this package registers the ported methods
(L2P, DualPrompt, CodaPrompt, DAP, MOE_ADAPTER4CL, RAPF, Finetune, ICarl,
EWC, LWF, WA, LUCIR, bic, DER, ERACE, ERAML, OCM, PRAKA)."""

from libcontinual_tpu_torch.methods import (  # noqa: F401
    bic, clip_methods, dap, der, er, ewc, finetune, icarl, lucir, lwf, ocm, praka,
    prompt_methods, wa)
