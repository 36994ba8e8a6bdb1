from repro_torch.serving.backends import (FusedPagedBackend, PagedBackend,
                                         PagedDecodeRunner, XlaPagedBackend,
                                         fused_kernel_hbm_bytes,
                                         fused_paged_extend, kernel_flops,
                                         kernel_hbm_bytes, make_backend,
                                         make_runner, xla_paged_extend)
from repro_torch.serving.engine import (GreedyDecode, Request, ServeStats,
                                        ServingEngine)
from repro_torch.serving.kvcache import PagedKVCache, PagedStats
from repro_torch.serving.prefill import (PackedPrefill, PackedPrefillRunner,
                                         bucket_for, default_buckets,
                                         plan_packs)

__all__ = ["FusedPagedBackend", "PagedBackend", "PagedDecodeRunner",
           "XlaPagedBackend", "fused_kernel_hbm_bytes", "fused_paged_extend",
           "kernel_flops", "kernel_hbm_bytes", "make_backend", "make_runner",
           "xla_paged_extend", "GreedyDecode", "Request", "ServeStats",
           "ServingEngine", "PagedKVCache", "PagedStats", "PackedPrefill",
           "PackedPrefillRunner", "bucket_for", "default_buckets",
           "plan_packs"]
