"""The port's multifactor priority against the JAX package's.

The same numpy attributes go through JAX ``multifactor_priority`` /
``priority_order`` and the port's (on the CPU).  The priorities must
match bit for bit (compared as int32 views) and the permutation must be
identical — with and without ``extra_service``, with an empty running
set, and with tied priorities.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cranesched_tpu.models import priority as jprio
from cranesched_tpu_torch import convert
from cranesched_tpu_torch.models import priority as tprio


def _attrs(rng, J, R, A, ties=False):
    p = dict(
        age=rng.integers(0, 2 * 14 * 24 * 3600, J).astype(np.int32),
        qos_prio=(rng.integers(0, 5, J) * 1000).astype(np.int32),
        part_prio=(rng.integers(0, 3, J) * 100).astype(np.int32),
        node_num=rng.integers(1, 4, J).astype(np.int32),
        cpus=(rng.integers(1, 65, J) / 4.0).astype(np.float32),
        mem=rng.integers(1, 1 << 16, J).astype(np.float32),
        account=rng.integers(0, A, J).astype(np.int32),
        valid=rng.random(J) > 0.1)
    if ties:
        # four distinct attribute rows repeated: many exact ties
        for k in p:
            if k != "valid":
                p[k] = p[k][np.arange(J) % 4]
    r = dict(
        qos_prio=(rng.integers(0, 5, R) * 1000).astype(np.int32),
        part_prio=(rng.integers(0, 3, R) * 100).astype(np.int32),
        node_num=rng.integers(1, 4, R).astype(np.int32),
        cpus=(rng.integers(1, 65, R) / 4.0).astype(np.float32),
        mem=rng.integers(1, 1 << 16, R).astype(np.float32),
        account=rng.integers(0, A, R).astype(np.int32),
        run_time=rng.integers(0, 10**6, R).astype(np.int32),
        valid=rng.random(R) > 0.2)
    return p, r


def _both(p, r, A, extra=None, weights=None):
    jw = jprio.PriorityWeights(**(weights or {}))
    tw = tprio.PriorityWeights(**(weights or {}))
    jp = jprio.multifactor_priority(
        jprio.PendingPriorityAttrs(**{k: jnp.asarray(v)
                                      for k, v in p.items()}),
        jprio.RunningPriorityAttrs(**{k: jnp.asarray(v)
                                      for k, v in r.items()}),
        jw, A, extra_service=None if extra is None else jnp.asarray(extra))
    tp = tprio.multifactor_priority(
        convert.pending_priority_attrs(device="cpu", **p),
        convert.running_priority_attrs(device="cpu", **r),
        tw, A, extra_service=None if extra is None else torch.tensor(extra))
    jo = np.asarray(jprio.priority_order(jp))
    to = tprio.priority_order(tp).numpy()
    return np.asarray(jp), tp.numpy(), jo, to


_CASES = ["plain", "extra_service", "empty_running", "ties", "large_job"]


@pytest.mark.parametrize("case", _CASES)
def test_priority_bitwise_and_order(case):
    rng = np.random.default_rng(_CASES.index(case))
    J, R, A = 300, 0 if case == "empty_running" else 200, 16
    p, r = _attrs(rng, J, R, A, ties=case == "ties")
    extra = None
    weights = None
    if case == "extra_service":
        extra = (rng.random(A) * 1e5).astype(np.float32)
        extra[::3] = 0.0
    if case == "large_job":
        weights = dict(job_size=500.0, favor_small=False)
    jp, tp, jo, to = _both(p, r, A, extra, weights)
    np.testing.assert_array_equal(jo, to)
    if case == "large_job":
        # a nonzero job_size weight: the compiled reference contracts
        # the weighted sum into fused multiply-adds, which the port's
        # eager float32 ops do not, so a few priorities differ by one
        # unit in the last place (ROADMAP C.1); the order must not
        ulp = jp.view(np.int32).astype(np.int64) - tp.view(np.int32)
        assert np.abs(ulp).max() <= 1
        return
    np.testing.assert_array_equal(jp.view(np.int32), tp.view(np.int32))
    if case == "ties":
        assert len(np.unique(tp[np.isfinite(tp)])) < J // 10


def test_service_sum_is_in_job_order():
    """The per-account service fold is sequential in job order: a sum
    whose value depends on the order (1e8 + 1 + ... in float32) matches
    the JAX package's scatter-add exactly."""
    vals = torch.tensor([1e8, 1.0, 1.0, 1.0, -1e8, 1.0], dtype=torch.float32)
    seg = torch.tensor([0, 0, 0, 0, 0, 1])
    out = tprio._segment_sum_in_order(vals, seg, 2)
    import jax
    ref = jax.ops.segment_sum(jnp.asarray(vals.numpy()),
                              jnp.asarray(seg.numpy()), num_segments=2)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  np.asarray(ref).view(np.int32))
