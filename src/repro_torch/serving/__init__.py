from repro_torch.serving.backends import (FusedPagedBackend, PagedBackend,
                                         PagedDecodeRunner, XlaPagedBackend,
                                         fused_kernel_hbm_bytes,
                                         fused_paged_extend, kernel_flops,
                                         kernel_hbm_bytes, make_backend,
                                         make_runner, xla_paged_extend)
from repro_torch.serving.engine import (GreedyDecode, Request, ServeStats,
                                        ServingEngine, SpeculativeDecode)
from repro_torch.serving.frontend import (QuotaExceeded, StreamingFrontend,
                                          TenantQuota, TokenStream)
from repro_torch.serving.kvcache import PagedKVCache, PagedStats, PrefixIndex
from repro_torch.serving.prefill import (PackedPrefill, PackedPrefillRunner,
                                         PrefillHandoff,
                                         bucket_for, default_buckets,
                                         plan_packs)
from repro_torch.serving.sessions import SessionManager
from repro_torch.serving.speculative import (SpecStats, SpeculativeDecoder,
                                             extend_step)

__all__ = ["FusedPagedBackend", "PagedBackend", "PagedDecodeRunner",
           "XlaPagedBackend", "fused_kernel_hbm_bytes", "fused_paged_extend",
           "kernel_flops", "kernel_hbm_bytes", "make_backend", "make_runner",
           "xla_paged_extend", "GreedyDecode", "Request", "ServeStats",
           "ServingEngine", "SpeculativeDecode", "PagedKVCache", "PagedStats",
           "PrefixIndex", "PackedPrefill", "PackedPrefillRunner",
           "PrefillHandoff",
           "bucket_for", "default_buckets", "plan_packs", "SessionManager",
           "SpecStats", "SpeculativeDecoder", "extend_step",
           "StreamingFrontend", "TenantQuota", "TokenStream",
           "QuotaExceeded"]
