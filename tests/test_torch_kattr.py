"""The port's attribution variants against the reference tool's Pallas
kernels.

Each variant of ``tools/kattr.py::make_variant`` runs through
``pl.pallas_call`` in interpret mode with ``run()``'s plumbing (the
SMEM job block of BJ jobs, the VMEM avail and cost, the (1, BJ) scratch
accumulator carried across the grid), and the port's plain version
(``attr_variant_plain``, what the kernel wrapper runs on CPU tensors)
must return the same checksum bit for bit: at J = 512, N = 1,024 on the
reference data, and with no feasible node anywhere.  The CUDA kernels
are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cranesched_tpu_torch.kernels import build
from cranesched_tpu_torch.models import gpu_solver
from cranesched_tpu_torch.tools import kattr

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("reference_kattr",
                                               ROOT / "tools" / "kattr.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

J, N, R, BJ = 512, 1024, 3, 256


def _pallas(kind, job, avail, cost):
    """``tools/kattr.py::run``'s call plumbing, in interpret mode."""
    W = avail.shape[-1]
    NB = job.shape[-1] // BJ
    fn = pl.pallas_call(
        ref.make_variant(kind, BJ, R, W),
        grid=(NB,),
        in_specs=[pl.BlockSpec((1, R + 4, BJ), lambda i: (0, 0, i),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_shape=jax.ShapeDtypeStruct((NB, 1, BJ), jnp.int32),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((1, BJ), jnp.int32)],
        interpret=True,
    )
    return np.asarray(jax.jit(fn)(jnp.asarray(job), jnp.asarray(avail),
                                  jnp.asarray(cost)))


def _data(case):
    job, avail, cost = kattr.make_data(J, N, R, BJ)
    if case == "infeasible":
        avail = np.zeros_like(avail)     # every request is >= 1
    return job, avail, cost


@pytest.mark.parametrize("case", ["reference", "infeasible"])
@pytest.mark.parametrize("kind", kattr.VARIANTS)
def test_variant_matches_pallas_interpret(kind, case):
    job, avail, cost = _data(case)
    want = _pallas(kind, job, avail, cost)
    got = kattr.attr_variant(kind, *kattr.kernel_inputs(
        job, avail, cost, device="cpu"), BJ)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "infeasible" and kind == "select":
        # the second pass re-picks node 0: s + INT32_MAX + 0, wrapped
        s = job[0].astype(np.int64).sum(axis=0)
        wrapped = (s + 2**31 - 1 + 2**31) % 2**32 - 2**31
        np.testing.assert_array_equal(got.numpy().reshape(-1), wrapped)


def test_make_data_is_the_reference_run_data():
    """``run()`` draws job, avail and cost from default_rng(0) in this
    order and these shapes (tools/kattr.py:88-95)."""
    n_pad = -(-1000 // 1024) * 1024
    j_pad = -(-300 // BJ) * BJ
    rng = np.random.default_rng(0)
    want = (rng.integers(1, 1000, (1, R + 4, j_pad)),
            rng.integers(0, 10000, (R, 8, n_pad // 8)),
            rng.integers(0, 100, (1, 8, n_pad // 8)))
    got = kattr.make_data(300, 1000, R, BJ)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w.astype(np.int32))


def test_kernel_inputs_layout_and_wrapper_on_cpu():
    """Node n = sublane * W + lane is row n of the kernel's avail; CPU
    tensors run the plain version and launch nothing."""
    job, avail, cost = kattr.make_data(J, N, R, BJ)
    kj, ka, kc = kattr.kernel_inputs(job, avail, cost, device="cpu")
    W = avail.shape[-1]
    n = np.arange(N)
    np.testing.assert_array_equal(ka.numpy(), avail[:, n // W, n % W].T)
    np.testing.assert_array_equal(kc.numpy(), cost[0, n // W, n % W])
    np.testing.assert_array_equal(kj.numpy(), job[0])
    before = dict(kattr.attr_variant.launches)
    for kind in kattr.VARIANTS:
        out = kattr.attr_variant(kind, kj, ka, kc, BJ)
        np.testing.assert_array_equal(
            out.numpy(), kattr.attr_variant_plain(kind, kj, ka, kc,
                                                  BJ).numpy())
    assert kattr.attr_variant.launches == before
    with pytest.raises(ValueError):
        kattr.attr_variant("full", kj, ka, kc, BJ)


def test_greedy_inputs_run_the_real_kernel_plain():
    """The ``full`` row's problem: every job a gang of two over every
    node, through greedy_place's plain version."""
    job, avail, cost = kattr.kernel_inputs(
        *kattr.make_data(64, 1024, block_jobs=64), device="cpu")
    jobs, nelig, elig, cpu_total, a, c, K = kattr.greedy_inputs(
        job, avail, cost)
    assert tuple(jobs.shape) == (1, 64, 7) and K == 2
    placed, reason, chosen = gpu_solver.greedy_place(
        jobs, nelig, elig, cpu_total, a, c, K)
    assert bool(placed.all()) and bool((chosen >= 0).all())
    assert not torch.equal(a, avail)        # fresh copies were updated


def test_bounds_grow_with_the_stages():
    ms = [kattr.bound(k, 100_000, 10_240, 3)[0]
          for k in (*kattr.VARIANTS, "full")]
    assert ms == sorted(ms) and ms[0] > 0
    assert kattr.bound("select", 100_000, 10_240, 3)[1] == "operations"


def test_main_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert kattr.main(["--jobs", "256", "--nodes", "1024"]) == 2


def test_build_cache_key_covers_every_header(tmp_path, monkeypatch):
    """A changed header changes every kernel's library path, so a stale
    library is never loaded; both sources are registered."""
    assert set(build.SOURCES) == {"greedy_place", "kattr_variants"}
    for src in build.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = tmp_path / "place_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// changed\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[k] != after[k] for k in build.SOURCES)
    assert len(set(after.values())) == len(after)


@pytest.mark.parametrize("nodes,state", [(10_240, "shared"),
                                         (20_480, "global")])
def test_variant_plan_matches_the_serial_kernel(nodes, state):
    """The variants lay their one block out as greedy_place lays out a
    serial solve over the same nodes (no class bits); bcast's bound
    counts its side output at that block's width."""
    plan = kattr.variant_plan(nodes, R)
    want = gpu_solver.launch_plan(nodes, R, 0, 0)
    assert plan == want and plan.state == state and plan.bits == "none"
    ms_wide = kattr.bound("bcast", 1, nodes, R)[0]
    assert ms_wide > 0
