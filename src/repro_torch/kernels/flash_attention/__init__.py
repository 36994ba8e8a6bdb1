from repro_torch.kernels.flash_attention.ops import (attention, decode,
                                                     decode_paged)

__all__ = ["attention", "decode_paged", "decode"]
