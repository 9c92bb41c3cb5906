"""Each fault a training cell can have, planted in the program underneath
a whole run (the harness's look for a card skipped, the rest of the run
as it is), has to turn ``correct`` false; the sound program keeps it
true. One card runs the cell, so it has no exchange between chips to
leave out."""

import pytest

import pio_tpu_torch.models.seqrec as seqrec


def _unchanged():
    real = seqrec._train_step

    def step(params, values, opt, *rest, **kw):
        _, _, loss = real(params, values, opt, *rest, **kw)
        return values, opt, loss

    return step


def _half_batch():
    real = seqrec._loss

    def loss(params, seqs, targets, mask, cfg, axes=seqrec.MeshAxes()):
        h = seqs.shape[0] // 2
        return real(params, seqs[:h], targets[:h], mask[:h], cfg, axes)

    return loss


FAULTS = {
    "unchanged": ("_train_step", _unchanged),
    "half_batch": ("_loss", _half_batch),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_turns_correct_false(fault, tiny_run, monkeypatch):
    attr, make = FAULTS[fault]
    monkeypatch.setattr(seqrec, attr, make())
    assert tiny_run("sasrec.train")["correct"] is False


@pytest.mark.parametrize("seed", [20240607, 2**33 + 1])
def test_the_sound_program_is_correct(seed, tiny_run):
    result = tiny_run("sasrec.train", seed=seed)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


def test_only_the_windows_first_run_takes_the_snapshot_hook(monkeypatch,
                                                             tiny_run):
    calls = []
    real = seqrec.train_seqrec

    def spy(*args, **kw):
        calls.append((kw.get("checkpoint") is not None,
                      kw.get("checkpoint_every")))
        return real(*args, **kw)

    monkeypatch.setattr(seqrec, "train_seqrec", spy)
    result = tiny_run("sasrec.train", seconds=0.5)
    assert result["window"]["units"] >= 2
    # set-up's warm-up run and the window's first run take it
    assert calls[:2] == [(True, 1), (True, 1)]
    assert set(calls[2:]) == {(False, 0)}
