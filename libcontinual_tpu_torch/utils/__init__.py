from libcontinual_tpu_torch.utils.logging import Logger, get_logger  # noqa: F401
from libcontinual_tpu_torch.utils.seeding import init_seed, make_generator  # noqa: F401
