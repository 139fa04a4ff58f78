"""``launch/train.py``, the port's LM training CLI, on the CPU.

``--arch zamba2-1.2b --reduced --steps 20 --device cpu``: 20 finite
losses, falling (the first-10 mean above the last-10 mean), within 5e-4
of the reference CLI's (``repro.launch.train`` with the same flags: the
same threefry init and data but for a few Zipf draws at a bin's edge,
tests/test_torch_tokens.py; measured equal to the 4 printed decimals),
and a ``--checkpoint`` that ``restore`` reads back into a model and an
AdamW state bitwise equal to those after the last step.

``--arch whisper-base --reduced --steps 3 --batch 2 --seq 40``: the
encoder-decoder's losses equal to the reference CLI's to 4 decimals.
"""
import numpy as np
import torch

from repro.launch import train as jtrain
from repro_torch.configs.base import get_arch, reduced
from repro_torch.launch import train
from repro_torch.optim.adamw import named

torch.set_num_threads(1)


def test_train_cli_falls_and_checkpoint_restores_bitwise(tmp_path, capsys):
    path = str(tmp_path / "lm.msgpack")
    final = {}

    def keep(i, params, opt, metrics):
        if i == 19:
            final["params"] = {n: p.detach().clone()
                               for n, p in named(params).items()}
            final["m"] = {n: t.clone() for n, t in opt["m"].items()}
            final["v"] = {n: t.clone() for n, t in opt["v"].items()}
            final["step"] = int(opt["step"])

    losses = train.main(["--arch", "zamba2-1.2b", "--reduced", "--steps",
                         "20", "--device", "cpu", "--checkpoint", path],
                        on_step=keep)
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[:10]) > np.mean(losses[-10:])
    out = capsys.readouterr().out
    assert "first-10-mean 6.0514 last-10-mean 5.4857" in out
    # the reference CLI's numbers for the same flags (its own run)
    jlosses = jtrain.main(["--arch", "zamba2-1.2b", "--reduced", "--steps",
                           "20"])
    np.testing.assert_allclose(losses, jlosses, atol=5e-4, rtol=0)
    cfg = reduced(get_arch("zamba2-1.2b"))
    model, opt, step = train.restore(path, cfg, "cpu")
    assert step == 20 and int(opt["step"]) == final["step"] == 20
    for n, p in named(model).items():
        assert torch.equal(p.detach(), final["params"][n]), n
    for which in ("m", "v"):
        for n, t in opt[which].items():
            assert torch.equal(t, final[which][n]), (which, n)


def test_audio_train_cli_matches_the_reference_cli(capsys):
    argv = ["--arch", "whisper-base", "--reduced", "--steps", "3",
            "--batch", "2", "--seq", "40"]
    losses = train.main(argv + ["--device", "cpu"])
    jlosses = jtrain.main(argv)
    assert len(losses) == 3 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, atol=5e-5, rtol=0)
    out = capsys.readouterr().out.splitlines()
    port = [l for l in out if l.startswith("first-10-mean")]
    assert len(port) == 2 and port[0] == port[1]
