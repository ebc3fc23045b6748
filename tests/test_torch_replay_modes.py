"""The port's replay modes over the wire against the JAX package's:
``--rpc`` with and without ``--wal`` (every job through
``SubmitBatchJobs`` over gRPC, the WAL, ``Tick``, the cycle and
dispatch) and ``--slo`` (the closed loop that audits itself from its own
telemetry).

Each case runs in both packages from the same seed (the port's on
``device="cpu"``) and compares the result dicts on every field but the
wall-clock ones (``WALL`` of ``tests/test_torch_replay.py``: ``wall_s``,
``jobs_per_wall_s``, ``submit_wall_s``, ``submit_jobs_per_s`` and the
``cycle_ms_*`` of a tick's RPC), including the audits, the SLO tables,
the gang counts and the migration record.
"""

import functools

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


@pytest.mark.parametrize("name", list(treplay.CONFIGS))
def test_rpc_wal_replay_matches_jax(name, tmp_path):
    def call(mod, kw):
        wal = str(tmp_path / f"{mod.__name__}.wal")
        run = functools.partial(mod._run_rpc, wal_path=wal)
        return mod.CONFIGS[name](0.005, np.random.default_rng(1), run=run,
                                 **kw)
    out = _both(call)
    assert out["mode"] == "rpc+wal"
    assert out["jobs_submitted"] == out["jobs_finished"] > 0
    assert out["completed"] >= out["jobs_finished"] * 0.95


def test_rpc_replay_without_wal_matches_jax():
    out = _both(lambda mod, kw: mod.replay_fifo(
        0.005, np.random.default_rng(2), run=mod._run_rpc, **kw))
    assert out["mode"] == "rpc"


@pytest.mark.parametrize("name", ["fifo", "backfill", "gres"])
def test_slo_closed_loop_matches_jax(name, tmp_path):
    def call(mod, kw):
        wal = str(tmp_path / f"{mod.__name__}.wal")
        run = functools.partial(mod._run_closed_loop, wal_path=wal)
        return mod.CONFIGS[name](0.01, np.random.default_rng(0), run=run,
                                 **kw)
    out = _both(call)
    audit = out["slo_assert"]
    assert audit["ok"], audit
    assert audit["ledger"]["lost"] == [] and audit["ledger"]["doubled"] == []
    assert audit["span_sum_checked"] == out["jobs_finished"]
