"""The port's replay harness (``cranesched_tpu_torch/replay.py``) against
the JAX package's ``replay.py``: the five BASELINE configurations (and
``topo``) driven end to end on the simulated node plane.

Every case runs the same replay from the same seed in both packages
(the port's on ``device="cpu"``) and compares the result dicts on every
field but the wall-clock ones, ``WALL``; then it asserts what
``tests/test_replay.py`` asserts.  The ``--rpc --wal`` and ``--slo``
modes are in ``tests/test_torch_replay_modes.py``, ``--federation`` and
``--rebalance`` in ``tests/test_torch_replay_fed.py``.  Without ``--device cpu`` the
port's ``main`` refuses to start where no card is visible.
"""

import json

import numpy as np
import pytest
import torch

from cranesched_tpu import replay as jreplay
from cranesched_tpu_torch import replay as treplay

# measured on the host's clock: the only fields that may differ
WALL = frozenset({"wall_s", "jobs_per_wall_s", "submit_wall_s",
                  "submit_jobs_per_s", "cycle_ms_mean", "cycle_ms_p99",
                  "cycle_ms_max"})


def unwalled(result):
    return {k: v for k, v in result.items() if k not in WALL}


def test_config_names_match():
    assert list(treplay.CONFIGS) == list(jreplay.CONFIGS)


@pytest.mark.parametrize("name", list(treplay.CONFIGS))
def test_replay_config_drains(name):
    want = jreplay.CONFIGS[name](0.01, np.random.default_rng(0))
    result = treplay.CONFIGS[name](0.01, np.random.default_rng(0),
                                   device="cpu")
    assert set(result) == set(want)
    assert unwalled(result) == unwalled(want)
    assert result["jobs_finished"] > 0
    # every job reaches a terminal state and the vast majority complete
    assert result["completed"] >= result["jobs_finished"] * 0.95
    assert result["cycles"] > 0


def test_replay_cli_json(capsys):
    assert jreplay.main(["fifo", "--scale", "0.005", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert treplay.main(["fifo", "--scale", "0.005", "--json",
                         "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fifo"]["jobs_finished"] >= 20
    assert unwalled(out["fifo"]) == unwalled(want["fifo"])
    # the text form prints the same line but for its wall-clock part
    assert jreplay.main(["fifo", "--scale", "0.005"]) == 0
    want = capsys.readouterr().out
    assert treplay.main(["fifo", "--scale", "0.005", "--device",
                         "cpu"]) == 0
    line = capsys.readouterr().out
    assert line.startswith("fifo      finished=50 completed=50 cycles=")
    assert line.split(" wall=")[0] == want.split(" wall=")[0]


@pytest.mark.parametrize("argv", [["fifo"], ["--federation"],
                                  ["all", "--rpc", "--device", "cuda"]],
                         ids=["default-device", "federation", "cuda"])
def test_main_refuses_without_a_card(argv, capsys, monkeypatch):
    """Without ``--device cpu`` the replay runs on the card; where none
    is visible it exits non-zero naming the device, and runs nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert treplay.main(argv) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "device 'cuda'" in out.err and "no CUDA device" in out.err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplay.replay_fifo(0.005, np.random.default_rng(0))
