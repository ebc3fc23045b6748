"""PyTorch/CUDA port of ``cranesched_tpu`` for one NVIDIA H100.

The JAX package stays in the repository as the reference; this package
sits beside it, imports nothing of it (nor JAX), and is held against it
bit for bit.  Slice 1 carries the immediate-fit scheduling cycle:
priority sort, factored job batch, the greedy placement on the
device-resident cluster state (a hand-written CUDA kernel,
``csrc/greedy_place.cu``), and the host commit.

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""
