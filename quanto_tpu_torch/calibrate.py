"""Activation-scale calibration.

PyTorch counterpart of `quanto_tpu/calibrate.py:65-193`. Quantized modules
call back into the active `Calibration` from their forward while their
`calibrating` flag is set; the scales are exponential moving averages of each
batch's absmax scale, kept as 0-d float32 buffers on the device. The update
is a `torch.where`, as in JAX, so calibration never waits for the card
(`debug` prints, and so reads the scales on the host).

Streamline: while calibrating, every module output is quantized and tagged
with a consumption cell (`tensor/activations.py`); quantization-aware
consumers (the W4A8 kernel path, quantized-input modules) mark
`quantized_use`, `.dequantize()` marks `dequantized`. On exit, output
quantization stays on only for modules whose outputs saw a quantized use.

`calibrate_jit` exists in the JAX package only to batch its traced programs
into one device call per batch; PyTorch runs eagerly, so `Calibration` is
already that path and `calibrate_jit` is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .nn.qmodule import QModuleMixin
from .quantize import named_qmodules
from .tensor.activations import attach_consumption_cell
from .tensor.optimizers import AbsmaxOptimizer
from .tensor.qarray import QArray
from .tensor.qtype import qint8, qtype


__all__ = ["absmax_scale", "Calibration"]


def absmax_scale(base: torch.Tensor, qt: qtype = qint8, axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric absmax scale of a tensor, in its dtype."""
    return AbsmaxOptimizer()(base, qt, axis)


def _updated_scale(scale: torch.Tensor, new_scale: torch.Tensor, momentum: float) -> torch.Tensor:
    """EMA update in float32; adopts the new scale outright while the scale is
    still uninitialized (== 1)."""
    new_scale = new_scale.float().reshape(())
    scale = scale.float()
    return torch.where(scale == 1.0, new_scale, momentum * scale + new_scale * (1.0 - momentum))


class Calibration:
    """Context manager calibrating the activation scales of quantized modules.

    Usage::

        with Calibration(model, momentum=0.9):
            for batch in samples:
                model(batch)
    """

    def __init__(self, model, *, momentum: float = 0.9, streamline: bool = True, debug: bool = False):
        self.model = model
        self.momentum = momentum
        self.streamline = streamline
        self.debug = debug
        self._names = {}  # module id -> name, for debug traces
        self._output_cells = {}  # module id -> consumption cells of its tagged outputs

    # --- hooks called by QModuleMixin ---------------------------------------

    def calibrate_input(self, module: QModuleMixin, x) -> None:
        """Update the module's input scale from a batch."""
        if module.activation_qtype is None:
            return
        if isinstance(x, QArray):
            # Downstream of a quantized producer: adopt the max of both scales.
            module.input_scale = torch.maximum(module.input_scale, x._scale.float().reshape(()))
            return
        batch_scale = absmax_scale(x, module.activation_qtype)
        module.input_scale = _updated_scale(module.input_scale, batch_scale, self.momentum)
        if self.debug:
            print(f"[calibrate] {self._name(module)}.input_scale <- {float(module.input_scale):.6g}")

    def calibrate_output(self, module: QModuleMixin, out) -> None:
        """Update the module's output scale from a batch."""
        if module.activation_qtype is None:
            return
        if isinstance(out, QArray):
            out = out.dequantize()
        batch_scale = absmax_scale(out, module.activation_qtype)
        module.output_scale = _updated_scale(module.output_scale, batch_scale, self.momentum)
        if self.debug:
            print(f"[calibrate] {self._name(module)}.output_scale <- {float(module.output_scale):.6g}")

    def tag_output(self, module: QModuleMixin, qout) -> None:
        """Attach a consumption cell to a module's quantized output."""
        cell = {"dequantized": False, "quantized_use": False}
        attach_consumption_cell(qout, cell)
        self._output_cells.setdefault(id(module), []).append(cell)

    def _name(self, module) -> str:
        return self._names.get(id(module), type(module).__name__)

    # --- context manager ------------------------------------------------------

    def __enter__(self) -> "Calibration":
        for name, m in named_qmodules(self.model):
            self._names[id(m)] = name
            m.calibrating = True
            m._calibration = self
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        for name, m in named_qmodules(self.model):
            m.calibrating = False
            m._calibration = None
            if not self.streamline or m.activation_qtype is None:
                continue
            if not any(c["quantized_use"] for c in self._output_cells.get(id(m), [])):
                # Output only ever dequantized (or unused): drop output quantization.
                m.quantize_outputs = False
                if self.debug:
                    print(f"[calibrate] streamline: disabled output quantization for {name}")
