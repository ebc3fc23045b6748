"""Device bring-up of the port: the bounded acquisition of the card
(``acquire``).  The sharded solves of ``cranesched_tpu/parallel/`` are
ROADMAP.md A10."""
