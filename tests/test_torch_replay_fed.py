"""The port's federation drills against the JAX package's:
``replay_federation`` (two WAL-backed shards and the arbiter on one
virtual clock, 40% cross-partition gangs, a shard killed right after a
durable gang reserve and recovered) and ``replay_rebalance`` (a live
migration of the loaded partition whose source dies mid-handoff, then
recovers and resolves), directly and through ``main``.

Each case runs in both packages from the same seed (the port's on
``device="cpu"``) and compares the result dicts on every field but the
wall-clock ones (``WALL`` of ``tests/test_torch_replay.py``), including
the ledgers, the gang counts, the migration record and the audits.
"""

import json

import numpy as np
import pytest

from cranesched_tpu import replay as jreplay
from cranesched_tpu_torch import replay as treplay
from test_torch_replay import unwalled


def _both(call):
    want = call(jreplay, {})
    got = call(treplay, {"device": "cpu"})
    assert set(got) == set(want)
    assert unwalled(got) == unwalled(want)
    return got


@pytest.mark.parametrize("scale", [0.05, 0.1])
def test_federation_drill_matches_jax(scale):
    out = _both(lambda mod, kw: mod.replay_federation(
        scale, np.random.default_rng(0), **kw))
    assert out["ok"]
    assert out["ledger"]["lost"] == 0 and out["ledger"]["doubled"] == 0
    assert out["gang_commits"] == out["gangs"] > 0
    assert out["recovered_at"] is not None


@pytest.mark.parametrize("scale", [0.05, 0.1])
def test_rebalance_drill_matches_jax(scale):
    out = _both(lambda mod, kw: mod.replay_rebalance(
        scale, np.random.default_rng(0), **kw))
    assert out["ok"]
    assert out["resolved"] == ["commit"]
    assert out["audit"]["lost"] == 0 and out["audit"]["doubled"] == 0
    assert out["migration"]["committed"] is False


def test_main_modes_match_jax(capsys):
    argv = ["backfill", "--scale", "0.005", "--slo", "--federation",
            "--rebalance", "--json"]
    assert jreplay.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert treplay.main(argv + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"backfill", "federation", "rebalance"}
    for key in out:
        assert unwalled(out[key]) == unwalled(want[key]), key
    assert out["backfill"]["slo_assert"]["ok"]
    assert out["federation"]["ok"] and out["rebalance"]["ok"]
