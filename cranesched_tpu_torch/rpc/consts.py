"""Wire constants shared by client and server (kept dependency-free so
the CLI can import the client without pulling the scheduler + JAX)."""

SERVICE = "cranesched.CraneCtld"
CRANED_SERVICE = "cranesched.Craned"
CFORED_SERVICE = "cranesched.CraneFored"
