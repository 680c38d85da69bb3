"""Finetune, the naive sequential baseline (``libcontinual_tpu/methods/finetune.py``):
plain CE on the full head, no forgetting mitigation. The base ``Method`` has
exactly these semantics; this subclass registers the name."""

from libcontinual_tpu_torch.core.method import Method
from libcontinual_tpu_torch.registry import METHODS


@METHODS.register("Finetune")
class Finetune(Method):
    pass
