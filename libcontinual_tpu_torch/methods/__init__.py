"""Method registry. Importing this package registers the ported methods
(L2P, DualPrompt, CodaPrompt, DAP, MOE_ADAPTER4CL, RAPF, Finetune, ICarl,
EWC, LWF, WA, LUCIR, bic, DER, ERACE, ERAML, OCM, PRAKA, GPM, TRGP, API,
DMNSP)."""

from libcontinual_tpu_torch.methods import (  # noqa: F401
    api, bic, clip_methods, dap, der, dmnsp, er, ewc, finetune, gpm, icarl, lucir, lwf, ocm,
    praka, prompt_methods, trgp, wa)
