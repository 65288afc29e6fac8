"""On-wire gradient compression — the port's copy of the compressors of
``horovod_tpu/common/compression.py``: none, fp16, bf16 and ef16.

A compressor names the dtype a floating tensor travels at inside the
all-reduce (``wire_dtype``); integer and bool tensors are never
compressed. ``resolve_compression("auto")`` follows ``HOROVOD_COMPRESSION``
with the same precedence as the JAX package: the config ``init()`` froze,
then the raw env, and no compression when the knob is unset.

``ef16`` is fp16 with error feedback: the optimizer keeps an fp32
residual per parameter element, adds it to the gradient before the fp16
cast and keeps the cast's error for the next step
(``apply_error_feedback``), so the rounding is re-injected instead of
lost. The raw collectives treat it as its fp16 wire format.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "Compressor",
    "NoneCompressor",
    "Fp16Compressor",
    "Bf16Compressor",
    "ErrorFeedbackCompressor",
    "Compression",
    "resolve_compression",
    "apply_error_feedback",
    "init_residual",
]


class Compressor:
    """``wire_dtype(dtype)``: the dtype a tensor of ``dtype`` travels at,
    or None when it is not compressed. ``compress``/``decompress`` keep
    Horovod's per-tensor ``(tensor, ctx)`` API."""

    name = "none"
    wire: Optional[torch.dtype] = None
    error_feedback = False

    def wire_dtype(self, dtype: torch.dtype) -> Optional[torch.dtype]:
        if self.wire is None or not dtype.is_floating_point:
            return None
        return self.wire

    def compress(self, tensor):
        w = self.wire_dtype(tensor.dtype)
        if w is None or w == tensor.dtype:
            return tensor, None
        return tensor.to(w), tensor.dtype

    def decompress(self, tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class NoneCompressor(Compressor):
    """Identity: tensors travel at their accumulation dtype."""

    name = "none"


class Fp16Compressor(Compressor):
    """float16 wire format: more mantissa than bf16, narrow exponent."""

    name = "fp16"
    wire = torch.float16


class Bf16Compressor(Compressor):
    """bfloat16 wire format: fp32's exponent range, 8 mantissa bits."""

    name = "bf16"
    wire = torch.bfloat16


class ErrorFeedbackCompressor(Compressor):
    """A lossy wire compressor with error feedback. Stateless: the
    residuals live in the optimizer's state (``opt.py``), and
    ``apply_error_feedback`` is the correct/quantize/keep-the-error step."""

    error_feedback = True

    def __init__(self, inner: Compressor, name: Optional[str] = None):
        if inner.wire is None:
            raise ValueError("error feedback needs a lossy wire format; "
                             "wrapping the NoneCompressor is meaningless")
        self.inner = inner
        self.name = name or f"ef-{inner.name}"
        self.wire = inner.wire


class Compression:
    """Option namespace (``hvd.Compression.none/fp16/bf16/ef16``)."""

    none = NoneCompressor()
    fp16 = Fp16Compressor()
    bf16 = Bf16Compressor()
    ef16 = ErrorFeedbackCompressor(Fp16Compressor(), name="ef16")


_BY_NAME = {"none": None, "fp16": Compression.fp16, "bf16": Compression.bf16,
            "ef16": Compression.ef16}


def resolve_compression(compression="auto") -> Optional[Compressor]:
    """Resolve a compression knob to a Compressor or None.

    - ``"auto"``: ``HOROVOD_COMPRESSION`` when it was set, else None.
    - ``None`` / ``"none"`` / ``Compression.none``: no compression.
    - ``"fp16"`` / ``"bf16"`` / ``"ef16"`` or a ``Compressor``: that
      compressor.
    """
    if compression is None:
        return None
    if isinstance(compression, Compressor):
        return None if isinstance(compression, NoneCompressor) else compression
    if not isinstance(compression, str):
        raise TypeError(f"cannot resolve compression from {compression!r}")
    name = compression
    if name == "auto":
        from . import config as _config
        from .state import global_state

        st = global_state()
        if (st.initialized and st.config is not None
                and st.config.compression_explicit):
            name = st.config.compression
        else:
            name = _config.parse_compression_env()
    if name not in _BY_NAME:
        raise ValueError(f"unknown compression {name!r}; expected one of "
                         f"{sorted(_BY_NAME)} or 'auto'")
    return _BY_NAME[name]


def apply_error_feedback(compressor: ErrorFeedbackCompressor,
                         grad: torch.Tensor, residual: torch.Tensor):
    """One error-feedback step on a gradient (a bucket's flat gradients):
    ``corrected = grad(fp32) + residual``, ``wire = corrected`` cast to
    the wire dtype, and the new residual ``corrected - wire(fp32)``.
    Returns ``(wire, new_residual)``. A gradient the wire format does not
    apply to (integers) passes through with a zero residual."""
    w = compressor.wire_dtype(grad.dtype)
    if w is None:
        return grad, torch.zeros_like(residual)
    corrected = grad.float() + residual
    wire = corrected.to(w)
    return wire, corrected - wire.float()


def init_residual(params):
    """fp32 zero residuals, one per element of each tensor of ``params``."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]
