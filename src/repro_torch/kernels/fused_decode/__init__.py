from repro_torch.kernels.fused_decode.ops import (oproj_ffn_swiglu,
                                                  qkv_rope_paged)

__all__ = ["qkv_rope_paged", "oproj_ffn_swiglu"]
