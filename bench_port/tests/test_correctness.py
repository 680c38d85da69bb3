"""The check that decides ``correct``, driven through a whole run at the
tiny size on the CPU (the look for a card skipped): a sound run passes; a
run with the timed step broken underneath, and the control (the reference
in float8 products put in the program's place), fail."""

import json

import pytest
import torch

from bench_port import calibrate, check, run
from libcontinual_tpu_torch.core.method import Method, weighted_accuracy
import tiny

SEED = 2 ** 31 + 2024


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.bench_tree(str(tmp_path_factory.mktemp("bench")))


def _run(tree, cell, capsys):
    bench_dir, bench = tree
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds", "0.2"]
    assert run.main(argv, device="cpu", bench_dir=bench_dir, bench=bench) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    return line


def _unchanged(step):
    """A step that computes its loss and returns the state unchanged."""
    def broken(self, state, batch, lr):
        batch = dict(batch, x=self.augment(state.rng, batch["image"], train=True))
        with torch.no_grad():
            loss, aux = self.loss(state, batch)
            acc = weighted_accuracy(aux["logits"], batch["label"], batch.get("weight"))
        return state, {"loss": loss, "acc": acc}
    return broken


def _half_batch(step):
    """The second half of every batch left out, the mean taken over the rest."""
    def broken(self, state, batch, lr):
        w = batch["weight"].clone()
        w[w.shape[0] // 2:] = 0.0
        return step(self, state, dict(batch, weight=w), lr)
    return broken


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_sound_run_is_correct(tree, cell, capsys):
    line = _run(tree, cell, capsys)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_broken_step_is_caught(tree, cell, fault, capsys, monkeypatch):
    monkeypatch.setattr(Method, "train_step", fault(Method.train_step))
    line = _run(tree, cell, capsys)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_control_fails(tree, cell):
    bench_dir, bench = tree
    r = run.resolve(cell, bench_dir, bench)
    out = calibrate.readings(r, SEED, True, device="cpu")
    assert check.judge(out["program"], r.cell["limits"])[0]
    assert not check.judge(out["control"], r.cell["limits"])[0], out["control"]
