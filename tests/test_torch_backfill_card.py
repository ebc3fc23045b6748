"""The backfill head kernel (``csrc/backfill_head.cu``) on the card,
against its plain loop ``solve_backfill_plain`` on the same card, bit for
bit on the placements, start buckets, nodes, reasons and the post-solve
time map and cost ledger (``backfill_head_cases.head_vs_plain``).

Every test here is marked ``card`` and skips without a CUDA device: the
kernel has no CPU form (the CPU tests hold ``solve_backfill_plain`` against
the JAX package).  On the card's machine, which has no JAX, run them
without the suite's conftest:

    python -m pytest tests/test_torch_backfill_card.py -m card --noconftest
"""

import pytest
import torch

from backfill_head_cases import head_problem, head_vs_plain
from cranesched_tpu_torch.models import solver_time as st

pytestmark = pytest.mark.card

WEEK = 7 * 86400


@pytest.fixture
def sms():
    """The card's SM count; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backfill head kernel has no "
                    "CPU form")
    return torch.cuda.get_device_properties(0).multi_processor_count


# name -> head_problem's shape: the benchmark's (N = 10,000, T = 64, R = 3,
# K = 2, J = 1,024) on the 60 s grid and on a week's geometric grid;
# contended (invalid rows, a one-node partition under gangs of up to K,
# jobs with no start in the window, time limits <= 0); gangs above the
# kernel's 8 keys a thread; T > 64 (two fit words); J = 0 and 1
_CASES = {
    "cell": dict(n=10_000, T=64, J=1024, K=2),
    "geometric": dict(n=10_000, T=64, J=1024, K=2, horizon=WEEK),
    "contended": dict(n=2_000, T=64, J=1024, K=4, contended=True),
    "contended-small": dict(n=40, T=16, J=300, K=3, contended=True),
    "gangs-above-8": dict(n=600, T=32, J=300, K=12),
    "t100": dict(n=3_000, T=100, J=400, K=2, horizon=WEEK),
    "j0": dict(n=500, T=64, J=0, K=2),
    "j1": dict(n=500, T=64, J=1, K=2),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_backfill_head_matches_plain_bitwise(sms, name):
    kw = _CASES[name]
    row = head_vs_plain(name, 100 + list(_CASES).index(name), **kw)
    assert row["state"] == "shared" and row["blocks"] <= sms
    if kw["J"] > 1:
        assert row["placed"] > 0 and row["future"] > 0
    if kw.get("contended"):
        assert row["no_start"] > 0


def test_backfill_head_global_state_matches_plain_bitwise(sms):
    """320 nodes a block: the owned rows (240 KB) stay in device memory."""
    row = head_vs_plain("global", 200, 320 * sms, 64, 256, 2)
    assert row["state"] == "global" and row["slice"] == 320


def test_backfill_head_counts_launches_on_the_route(sms):
    """``solve_backfill`` on card tensors is one launch of the kernel."""
    state, jobs, edges = head_problem(300, 800, 64, 64, 2)
    before = st.backfill_head.launches
    st.solve_backfill(state, jobs, edges=edges, max_nodes=2)
    torch.cuda.synchronize()
    assert st.backfill_head.launches == before + 1
