"""fpga_mpeg2_encoder_tpu: an MPEG-2 video encoder framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
WangXuan95/FPGA-MPEG2-encoder hardware IP: YUV 4:4:4 in, ISO 13818-2 MPEG-2
elementary stream out, bit-exact against the golden model of the reference
datapath.
"""
from .config import EncoderConfig, SequenceConfig
from .models.encoder import Encoder

__version__ = "0.1.0"
__all__ = ["Encoder", "EncoderConfig", "SequenceConfig", "__version__"]
