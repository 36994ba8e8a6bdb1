from repro_torch.kernels.flash_attention.ops import decode, decode_paged

__all__ = ["decode_paged", "decode"]
