"""Gradient compression of the torch binding (``hvd.Compression``):
``none``, ``fp16`` and ``bf16``, each with Horovod's per-tensor
``compress(tensor) -> (tensor, ctx)`` / ``decompress(tensor, ctx)``.
They are the port's compressors (``common/compression.py``)."""

from ..common.compression import (Bf16Compressor, Compressor,
                                  Fp16Compressor, NoneCompressor)


class Compression:
    """Option namespace: ``Compression.none``, ``Compression.fp16``,
    ``Compression.bf16``."""

    Compressor = Compressor
    none = NoneCompressor()
    fp16 = Fp16Compressor()
    bf16 = Bf16Compressor()


FP16Compressor = Fp16Compressor
BF16Compressor = Bf16Compressor
