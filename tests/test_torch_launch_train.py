"""The port's training driver (``repro_torch.launch.train``) on the CPU:
``--smoke --device cpu`` with checkpoints, then a restart from the latest
one that gives the unbroken run's losses bit for bit (the pipeline replays
from the restored step); every LM arch of the registry through it; the
default device raises without a card.  The driver installs signal
handlers, as JAX's does; each test puts the process's back."""
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from repro_torch.launch import train

SMALL = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16"]


@pytest.fixture(autouse=True)
def _keep_signal_handlers():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_restart_replays_the_unbroken_run_bit_for_bit(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = SMALL + ["--steps", "6", "--checkpoint-every", "3",
                    "--checkpoint-dir", d]
    unbroken = train.main(argv)
    assert [m["step"] for m in unbroken] == [1, 2, 3, 4, 5, 6]
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000006"]
    first = capsys.readouterr().out
    assert (f"[train] smollm-135m: loss {unbroken[0]['loss']:.3f} -> "
            f"{unbroken[-1]['loss']:.3f} over 6 steps") in first
    shutil.rmtree(os.path.join(d, "step_00000006"))
    restarted = train.main(argv)
    assert "[train] restored from step 3" in capsys.readouterr().out
    assert [m["step"] for m in restarted] == [4, 5, 6]
    assert ([m["loss"] for m in restarted]
            == [m["loss"] for m in unbroken[3:]])
    # a run that has reached its last step restores and runs nothing
    assert train.main(argv) == []


@pytest.mark.parametrize("arch", ["qwen3-4b", "smollm-135m", "qwen2-0.5b",
                                  "mixtral-8x22b", "olmoe-1b-7b"])
def test_every_lm_arch_trains_through_the_driver(arch):
    log = train.main(SMALL + ["--arch", arch, "--steps", "2",
                              "--microbatches", "2"])
    assert len(log) == 2
    assert all(np.isfinite(m["loss"]) and m["loss"] > 0 for m in log)
    assert set(log[0]) == {"loss", "lr", "grad_norm", "step"}


def test_driver_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="LM archs"):
        train.main(SMALL + ["--arch", "din", "--steps", "1"])
    with pytest.raises(ValueError, match="LM archs"):
        train.main(SMALL + ["--arch", "schnet", "--steps", "1"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--smoke", "--steps", "1"])
