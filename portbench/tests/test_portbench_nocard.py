"""Without a CUDA device the run exits non-zero and prints no result; it
never falls back to the CPU."""

from __future__ import annotations

import pytest

from portbench import run


def test_exits_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "base.batch", "--seed", str(2**31 + 5), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "CUDA" in out.err


def test_exits_with_too_few_cards(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "base.batch", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.main(["--workload", "no.such.cell", "--seed", "1", "--seconds", "1"])
