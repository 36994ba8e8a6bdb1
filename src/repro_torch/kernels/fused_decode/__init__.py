from repro_torch.kernels.fused_decode.ops import (decoder_layer_step,
                                                  ffn_swiglu,
                                                  layer_step_params,
                                                  oproj_ffn_swiglu, qkv_rope,
                                                  qkv_rope_paged)

__all__ = ["qkv_rope_paged", "oproj_ffn_swiglu", "qkv_rope", "ffn_swiglu",
           "decoder_layer_step", "layer_step_params"]
