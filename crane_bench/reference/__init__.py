"""The plain reference of a scheduling cycle, in NumPy.

It imports nothing of the program (``cranesched_tpu_torch``), nothing of the
JAX package and no JAX.  It is a transcription of the semantics the port pins
(multifactor priority in float32, greedy placement on an int32 fixed-point
MinCpuTimeRatioFirst ledger with ties to the lowest node index, the split
backfill's time-axis head and its tail against the minimum over the horizon)
written for the traffic this benchmark sends: one account, no QoS, no holds,
dependencies, reservations or licenses.
"""
