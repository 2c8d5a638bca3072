"""The port's model examples (`examples/torch/serve_lm.py`, `train_lm.py`,
`train_recsys.py`) on the CPU at a tiny size against the reference's
scripts. Each package draws its initial weights its own way (the reference
with `jax.random`, the port from a seeded `torch.Generator`), so what
depends on that draw is not compared: the generated token ids, the losses,
the AUC and the retrieved candidate ids. Compared: serve's requests,
tokens and batch steps and the order of its lines; train_lm's log steps,
its parameter count and its summary keys; train_recsys's log steps and
the shape of its AUC and top-5 lines (an AUC in [0, 1], five distinct ids
in the candidate range)."""

import json
import re
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_script(path, capsys, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", [str(path)] + list(argv))
    try:
        runpy.run_path(str(path), run_name="__main__")
    except SystemExit as done:          # the launchers' scripts exit with main's code
        assert done.code in (0, None)
    return capsys.readouterr().out


def test_serve_lm_example(capsys, monkeypatch):
    argv = ["--requests", "3", "--slots", "2", "--gen-len", "4",
            "--arch", "granite-moe-1b-a400m"]
    want = run_script(ROOT / "examples" / "serve_lm.py", capsys, monkeypatch, argv)
    got = run_script(ROOT / "examples" / "torch" / "serve_lm.py", capsys, monkeypatch,
                     argv + ["--device", "cpu"])
    head = lambda out: re.sub(r"[\d.]+s \([\d.]+ tok/s\)", "<t>", out.splitlines()[0])
    assert head(got) == head(want) == "[serve] 3 requests, 12 tokens, <t>, 6 batch steps"
    shape = lambda out: [re.sub(r"\d+", "<id>", line) for line in out.splitlines()[1:]]
    assert shape(got) == shape(want)


def test_train_lm_example(tmp_path, capsys, monkeypatch):
    argv = ["--preset", "tiny", "--steps", "4", "--log-every", "2"]
    want = run_script(ROOT / "examples" / "train_lm.py", capsys, monkeypatch,
                      argv + ["--ckpt-dir", str(tmp_path / "jax")])
    got = run_script(ROOT / "examples" / "torch" / "train_lm.py", capsys, monkeypatch,
                     argv + ["--ckpt-dir", str(tmp_path / "torch"), "--device", "cpu"])
    shape = lambda out: [re.sub(r"-?\d+\.\d+(e-?\d+)?", "<x>", line)
                         for line in out.splitlines()[:-1]]
    assert shape(got) == shape(want)
    assert "[train] arch=granite-3-8b preset=tiny" in got
    summary = lambda out: json.loads(out.splitlines()[-1])
    assert set(summary(got)) == set(summary(want)) | {"launches"}
    assert summary(got)["launches"] == {}           # the CPU launches no kernel


def test_train_recsys_example(capsys, monkeypatch):
    argv = ["--steps", "40", "--batch", "64"]
    want = run_script(ROOT / "examples" / "train_recsys.py", capsys, monkeypatch, argv)
    got = run_script(ROOT / "examples" / "torch" / "train_recsys.py", capsys, monkeypatch,
                     argv + ["--device", "cpu"])
    from repro_torch import configs

    rows = configs.get("deepfm").make_reduced().total_vocab
    cands = min(rows, 100_000 % rows + 1000)
    for out in (want, got):
        lines = out.splitlines()
        assert [re.sub(r"bce [\d.]+", "bce <x>", x) for x in lines[:2]] == \
            ["step 20: bce <x>", "step 40: bce <x>"]
        auc = float(re.fullmatch(r"held-out AUC: ([\d.]+)", lines[2]).group(1))
        assert 0.0 <= auc <= 1.0
        ids = json.loads(lines[3].split(":", 1)[1])
        assert len(set(ids)) == 5 and all(0 <= i < cands for i in ids)
