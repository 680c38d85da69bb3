"""The PyTorch port stands alone: importing it, and running its CLI's
``--help``, loads no JAX, Flax, optax, PyYAML or ``libcontinual_tpu``."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "yaml", "libcontinual_tpu")

_PROBE = """
import json, runpy, sys
{body}
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in {forbidden!r})))
"""

MODULES = [
    "libcontinual_tpu_torch",
    "libcontinual_tpu_torch.core.trainer",
    "libcontinual_tpu_torch.convert",
    "libcontinual_tpu_torch.ops.attention",
    "libcontinual_tpu_torch.ops.prefix_attention",
    "libcontinual_tpu_torch.ops.masked_attention",
    "libcontinual_tpu_torch.ops.conv",
    "libcontinual_tpu_torch.ops.layer_norm",
    "libcontinual_tpu_torch.core.buffer",
    "libcontinual_tpu_torch.models.resnet",
    "libcontinual_tpu_torch.methods.icarl",
    "libcontinual_tpu_torch.methods.finetune",
    "libcontinual_tpu_torch.methods.ewc",
    "libcontinual_tpu_torch.methods.lwf",
    "libcontinual_tpu_torch.methods.wa",
    "libcontinual_tpu_torch.methods.lucir",
    "libcontinual_tpu_torch.methods.bic",
    "libcontinual_tpu_torch.methods.der",
    "libcontinual_tpu_torch.methods.er",
    "libcontinual_tpu_torch.methods.ocm",
    "libcontinual_tpu_torch.methods.praka",
    "libcontinual_tpu_torch.models.cbam",
    "libcontinual_tpu_torch.models.heads",
    "libcontinual_tpu_torch.methods.prompt_methods",
    "libcontinual_tpu_torch.methods.dap",
    "libcontinual_tpu_torch.methods.clip_methods",
    "libcontinual_tpu_torch.models.clip",
    "libcontinual_tpu_torch.models.tokenizer",
    "libcontinual_tpu_torch.data.continual",
    "libcontinual_tpu_torch.config",
    "libcontinual_tpu_torch.tools.bench_attention",
    "libcontinual_tpu_torch.tools.exp_flash_kernel",
    "libcontinual_tpu_torch.models.alexnet",
    "libcontinual_tpu_torch.models.vit",
    "libcontinual_tpu_torch.methods.gpm",
    "libcontinual_tpu_torch.methods.trgp",
    "libcontinual_tpu_torch.methods.api",
    "libcontinual_tpu_torch.methods.dualgpm",
    "libcontinual_tpu_torch.methods.dmnsp",
]


def _loaded(body: str, args=()):
    code = _PROBE.format(body=body, forbidden=set(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax_or_yaml(module):
    assert _loaded(f"import {module}") == []


def test_cli_help_loads_no_jax_or_yaml():
    body = (
        "sys.argv = ['libcontinual_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('libcontinual_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code"
    )
    assert _loaded(body) == []


def test_config_without_file_needs_no_yaml():
    body = (
        "from libcontinual_tpu_torch.config import Config\n"
        "cfg = Config(overrides={'seed': 3}).get_config_dict()\n"
        "assert cfg['seed'] == 3 and cfg['optimizer']['name'] == 'SGD'"
    )
    assert _loaded(body) == []


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared ``.cuh`` header changes every library's build
    path, so a stale library is never loaded."""
    from libcontinual_tpu_torch.ops import _build

    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "b.cu").write_text("// no header\n")
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {n: _build.library_path(n) for n in ("a", "b")}
    (tmp_path / "common.cuh").write_text("// two\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
    assert before["a"] != before["b"] and os.path.basename(after["a"]).startswith("a_")


def test_real_sources_share_one_header():
    """Three libraries: ``attention.cu`` on the shared headers, for the three
    packed attention families (their one-pass forward and backward in headers
    of their own) and the generic forward, ``conv.cu`` on the packed kernels'
    header alone (its cp.async, ldmatrix and mma.sync primitives), and
    ``layer_norm.cu`` on none. Each exports every function its wrappers type,
    and nothing is typed twice."""
    from libcontinual_tpu_torch.ops import _build

    assert sorted(os.listdir(_build.CSRC_DIR)) == ["attention.cu", "attention_kernels.cuh",
                                                   "conv.cu", "generic_attention.cuh",
                                                   "layer_norm.cu",
                                                   "onepass_attention.cuh",
                                                   "onepass_attention_bwd.cuh"]
    assert tuple(_build.SIGNATURES) == _build.LIBRARIES == ("attention", "conv", "layer_norm")
    src = {}
    for name in _build.LIBRARIES:
        with open(os.path.join(_build.CSRC_DIR, name + ".cu")) as f:
            src[name] = f.read()
        for fn in _build.SIGNATURES[name]:
            assert f'extern "C" int {fn}(' in src[name], fn
        assert len(re.findall(r'extern "C" int lct_', src[name])) == len(_build.SIGNATURES[name])
    assert '#include "attention_kernels.cuh"' in src["attention"]
    assert '#include "generic_attention.cuh"' in src["attention"]
    assert '#include "onepass_attention.cuh"' in src["attention"]
    assert '#include "onepass_attention_bwd.cuh"' in src["attention"]
    # the one-pass kernels' one predicate, for the forward and the backward
    assert [fn for fn in _build.SIGNATURES["attention"] if "onepass" in fn] == ["lct_attn_onepass"]
    assert re.findall(r'#include "(\w+\.cuh)"', src["conv"]) == ["attention_kernels.cuh"]
    assert {fn.split("_")[1] for fn in _build.SIGNATURES["attention"]} == {"qkv", "pqkv", "mqkv",
                                                                            "attn"}
    assert {fn.split("_")[1] for fn in _build.SIGNATURES["conv"]} == {"conv3x3"}
    assert re.findall(r'#include "(\w+\.cuh)"', src["layer_norm"]) == []
    assert {fn.split("_")[1] for fn in _build.SIGNATURES["layer_norm"]} == {"ln"}


def test_cli_parses_overrides_without_yaml():
    from libcontinual_tpu_torch.__main__ import parse_overrides

    assert parse_overrides(["epoch=2", "lr=1e-3", "augment=False", "dataset=synthetic",
                            "mesh={\"data\": 1}", "x=null"]) == {
        "epoch": 2, "lr": 1e-3, "augment": False, "dataset": "synthetic",
        "mesh": {"data": 1}, "x": None,
    }
