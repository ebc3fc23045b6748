"""PyTorch/CUDA port of ``cranesched_tpu`` for one NVIDIA H100.

The JAX package stays in the repository as the reference; this package
sits beside it, imports nothing of it (nor JAX), and is held against it
bit for bit.  It carries the scheduling cycle: priority sort, factored
job batch, the greedy placement on the device-resident cluster state (a
hand-written CUDA kernel, ``csrc/greedy_place.cu``), the backfill
cycle of the default configuration (the time-axis solve of
``models/solver_time.py`` for the head, the greedy kernel for the
tail), and the host commit.  ``tools/kattr.py`` attributes the greedy
kernel's time per job to its stages with stripped CUDA variants
(``csrc/kattr_variants.cu``).  Around the cycle: the job lifecycle with
its WAL and recovery (``ctld/``), the observability planes (``obs/``),
and the controller daemon (``ctld_main.py``): the CraneCtld gRPC service
and its client (``rpc/``), the YAML config, auth tokens and TLS
(``utils/``, ``ctld/auth.py``), the leader's WAL lease and snapshots
(``ha/``) and the bounded acquisition of the card (``parallel/``).

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""
