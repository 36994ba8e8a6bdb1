"""Tensor-parallel partitioning rules (the serving subset of
``repro.distributed``) and the single-device train step (``stepfn``)."""
