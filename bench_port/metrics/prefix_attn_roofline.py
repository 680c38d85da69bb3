"""``prefix_attn_roofline``: the prefix-mode attention kernels' share of their
roofline (DualPrompt's and CODA-Prompt's prompt blocks; moves
``train_img_per_s``): the sum of the bounds of the sub-window's ``pqkv_fwd``
and ``pqkv_bwd`` launches over the device time of the attention kernels that
ran in the prefix mode, by the mode in their device names."""

import re

from bench_port import bounds

#: the prefix mode among the attention kernels' modes (0 qkv, 1 prefix, 2 masked)
PREFIX_MODE = 1
#: an attention kernel's template arguments in its device name:
#: ``attn_fwd_kernel<1, 256>`` (one-pass, <MODE, KEYS>) or
#: ``attn_fwd_kernel<__nv_bfloat16, 64, 1>`` (streaming, <T, HDP, MODE>)
TEMPLATE_ARGS = re.compile(r"\battn_(?:fwd|bwd_dq|bwd_dkdv)_kernel<([^<>]*)>")
KINDS = ("pqkv_fwd", "pqkv_bwd")


def mode_of(name: str):
    """The mode of an attention kernel's device name, or None for another
    kernel: the first template argument of a one-pass kernel, the last of a
    streaming one."""
    m = TEMPLATE_ARGS.search(name)
    if m is None:
        return None
    args = [a.strip() for a in m.group(1).split(",")]
    digits = re.search(r"\d+", args[0] if len(args) == 2 else args[-1])
    return int(digits.group()) if digits else None


def read(t):
    launches = [(kind, shape) for kind, shape in t.get("launches") or [] if kind in KINDS]
    seconds = sum(d for name, d in t.get("kernels", []) if mode_of(name) == PREFIX_MODE)
    if not launches or seconds <= 0.0:
        return None
    return 100.0 * sum(bounds.launch_bound(kind, shape) for kind, shape in launches) / seconds
