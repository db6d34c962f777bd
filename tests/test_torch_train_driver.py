"""The port's LM training driver, ``repro_torch.launch.train``, on the CPU:
the reference's driver tests (``tests/test_system.py``) run on the port,
and held bit for bit where the reference's tests only ask for finite
losses: the failure drill repeats the restored step and otherwise gives the
uninterrupted run's losses, and ``--resume`` gives an uninterrupted run's
last steps. (The reference's driver does not run on the CPU, see
``ROADMAP.md`` §3; its model math is what ``test_torch_lm_train.py``
holds the port to.) Every run uses one intra-op thread: the embedding
gather's backward (``index_put_`` with ``accumulate=True``) is not
repeatable on the CPU with several. The same drills run on the card in
``chip_smoke.py`` phase 18 (c)."""
import math

import pytest
import torch

from repro_torch.launch import train as T


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def args(tmp_path, name, arch="qwen3-4b", steps=10, batch=4, seq=32,
         every=3, *extra):
    return ["--device", "cpu", "--arch", arch, "--reduced", "--steps",
            str(steps), "--batch", str(batch), "--seq", str(seq),
            "--ckpt-dir", str(tmp_path / name), "--ckpt-every", str(every),
            *extra]


def test_train_driver_end_to_end(tmp_path):
    losses = T.main(args(tmp_path, "ck", every=4))
    assert len(losses) == 10
    assert all(math.isfinite(x) for x in losses)
    # checkpoints at steps 4 and 8, the newest kept
    from repro_torch.checkpoint import Checkpointer
    assert Checkpointer(str(tmp_path / "ck")).steps() == [4, 8]


def test_train_driver_failure_recovery(tmp_path):
    """``--simulate-failure 6 --ckpt-every 3``: the controller sees the one
    host die at step 6, the driver restores step 6's checkpoint and runs
    step 6 again; the losses are the uninterrupted run's, bit for bit, with
    step 6 repeated."""
    plain = T.main(args(tmp_path, "a"))
    lines = []
    out = T.train("qwen3-4b", reduced=True, steps=10, batch=4, seq=32,
                  ckpt_dir=str(tmp_path / "b"), ckpt_every=3,
                  simulate_failure=6, device="cpu", log=lines.append)
    drill = out["losses"]
    assert all(math.isfinite(x) for x in drill)
    assert len(drill) == 11 and drill[6] == drill[7]
    assert drill[:7] + drill[8:] == plain
    # the one host is the one that died; as in the reference, the drill
    # replans over the devices still attached (one), not the event's count
    assert [(e.step, e.dead_hosts, e.surviving_devices)
            for e in out["events"]] == [(6, ["host0"], 0)]
    assert any("re-meshed to (1, 1), resumed at step 6" in m
               for m in lines)
    assert int(out["state"].step) == 10


def test_train_driver_resume(tmp_path):
    T.main(args(tmp_path, "ck", "gemma2-2b", 6, 2, 16))
    losses = T.main(args(tmp_path, "ck", "gemma2-2b", 9, 2, 16, 3,
                         "--resume"))
    assert len(losses) == 3     # resumed from step 6
    whole = T.main(args(tmp_path, "whole", "gemma2-2b", 9, 2, 16))
    assert losses == whole[6:]


def test_train_returns_the_final_state_and_rates(tmp_path):
    out = T.train("gemma2-2b", reduced=True, steps=3, batch=2, seq=16,
                  ckpt_dir=str(tmp_path / "ck"), ckpt_every=0, device="cpu",
                  seed=4, log=lambda m: None)
    assert out["start_step"] == 0 and len(out["step_ms"]) == 3
    assert out["peak_mem_gib"] is None and out["tokens_per_s"] > 0
    assert out["plan"].shape == (1, 1) and out["plan"].dp_degree == 1
    assert not (tmp_path / "ck").exists() or \
        not any((tmp_path / "ck").iterdir())     # --ckpt-every 0: none
    again = T.train("gemma2-2b", reduced=True, steps=3, batch=2, seq=16,
                    ckpt_dir=str(tmp_path / "ck2"), ckpt_every=0,
                    device="cpu", seed=5, log=lambda m: None)
    assert again["losses"] != out["losses"]       # --seed draws anew


def test_driver_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        T.main(["--reduced", "--steps", "1", "--ckpt-dir",
                str(tmp_path / "ck")])


def test_tokens_per_s_leave_out_the_warm_up_step(tmp_path):
    """tokens/s are the tokens of the steps after the first over the sum
    of their times; one step alone gives none."""
    kw = dict(reduced=True, batch=2, seq=16, ckpt_every=0, device="cpu",
              log=lambda m: None)
    out = T.train("gemma2-2b", steps=3, ckpt_dir=str(tmp_path / "a"), **kw)
    warm = out["step_ms"][1:]
    assert out["tokens_per_s"] == 2 * 16 * 2 / (sum(warm) / 1e3)
    one = T.train("gemma2-2b", steps=1, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(one["step_ms"]) == 1 and one["tokens_per_s"] is None


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-780m",
                                  "jamba-v0.1-52b"])
def test_driver_trains_the_moe_and_ssm_families(arch, tmp_path):
    """The MoE, Mamba2 and hybrid configs train through the driver: finite
    losses, every parameter leaf moved (the step's warm-up keeps the
    learning rate near 0, so six steps need not lower the loss of fresh
    batches), ``moe_aux`` reported every step (positive with MoE, 0
    without), and a second identical run the same bit for bit."""
    kw = dict(reduced=True, steps=6, batch=2, seq=32, ckpt_every=0,
              device="cpu", log=lambda m: None)
    out = T.train(arch, ckpt_dir=str(tmp_path / "a"), **kw)
    losses = out["losses"]
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    from repro_torch.lm.model import TransformerLM
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch import configs as C
    init = TransformerLM(C.get_reduced(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert all(not torch.equal(a, b) for a, b in zip(
        tree_leaves(out["state"].params), tree_leaves(init)))
    assert len(out["moe_aux"]) == 6
    assert all((a > 0) == ("mamba2" not in arch) for a in out["moe_aux"])
    again = T.train(arch, ckpt_dir=str(tmp_path / "b"), **kw)
    assert again["losses"] == losses and again["moe_aux"] == out["moe_aux"]


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
def test_driver_trains_the_cross_attention_configs(arch, tmp_path):
    """The encoder-decoder and vision-language configs train through the
    driver on the stream's stubbed frontends: finite losses, every
    parameter leaf moved (the encoder's and ``frontend_proj`` included),
    and the failure drill (``--simulate-failure 4 --ckpt-every 2``) the
    uninterrupted run's losses bit for bit, step 4 repeated."""
    kw = dict(reduced=True, steps=6, batch=2, seq=16, ckpt_every=2,
              device="cpu", log=lambda m: None)
    out = T.train(arch, ckpt_dir=str(tmp_path / "a"), **kw)
    losses = out["losses"]
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    from repro_torch import configs as C
    from repro_torch.lm.model import TransformerLM
    from repro_torch.optim.adamw import tree_leaves
    init = TransformerLM(C.get_reduced(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    params = out["state"].params
    assert ("encoder" in params) == (arch == "whisper-medium")
    assert ("frontend_proj" in params) == (arch != "whisper-medium")
    assert all(not torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(init)))
    drill = T.train(arch, ckpt_dir=str(tmp_path / "b"), simulate_failure=4,
                    **kw)["losses"]
    assert len(drill) == 7 and drill[4] == drill[5]
    assert drill[:5] + drill[6:] == losses
