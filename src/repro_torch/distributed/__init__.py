"""Distribution (counterpart of ``repro.distributed``): partitioning rules
(``partitioning``), the activation-sharding context and perf options
(``ctx``), the train / prefill / decode step builders on one device or a
mesh (``stepfn``), the GPipe pipeline (``pipeline``) and the int8
compressed all-reduce (``compression``). Submodules are imported directly
(``ctx`` is imported by the models, ``partitioning`` imports
``models.common``)."""
