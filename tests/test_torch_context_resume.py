"""The context archs (llama-3.2-vision-90b, whisper-large-v3) trained
on the CPU, reduced, from the Trainer's own seeded init (vision's xgate
0, as the reference inits it): a crash and resume bit for bit against
an uninterrupted run, and ``launch.train`` crashed and resumed.  The Trainer's settings are
``test_torch_context_train.py``'s.
"""
import pytest

from repro_torch.launch import train as tlaunch
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig
from repro_torch.train_resume import mismatches, twin_run

from test_torch_context_model import CONTEXTS, _models
from test_torch_context_train import _trainer_config


@pytest.mark.parametrize("arch", CONTEXTS)
def test_context_crash_resume_bit_consistent(arch, tmp_path):
    """A reduced run crashed after step 6 and resumed from its step-4
    checkpoint: every loss and the final parameters equal an
    uninterrupted run's bit for bit."""
    _, mt = _models(arch)
    tc = _trainer_config(TTrainerConfig, tmp_path / "a")
    out = twin_run(mt, tc, crash_at=6, device="cpu")
    assert out["resumed_at"] == 4
    assert mismatches(out) == []


@pytest.mark.parametrize("arch", CONTEXTS)
def test_launch_train_context_crash_returns_zero(arch, tmp_path, capsys):
    rc = tlaunch.main(["--arch", arch, "--device", "cpu", "--crash-at-step",
                       "6", "--steps", "10", "--ckpt-dir", str(tmp_path)])
    said = capsys.readouterr().out
    assert rc == 0
    assert "CRASH injected at step 6" in said and '"final_step": 9' in said
