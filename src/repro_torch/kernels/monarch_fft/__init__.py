from repro_torch.kernels.monarch_fft.ops import (monarch, monarch_conv,
                                                 operational_intensity)
from repro_torch.kernels.monarch_fft import ref

__all__ = ["monarch", "monarch_conv", "operational_intensity", "ref"]
