"""Tensor-parallel partitioning rules (the serving subset of
``repro.distributed``)."""
