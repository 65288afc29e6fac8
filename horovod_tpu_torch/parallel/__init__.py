"""Parallelism beyond data parallel: the mesh's axis groups and sequence
(context) parallel attention, ring and Ulysses."""
