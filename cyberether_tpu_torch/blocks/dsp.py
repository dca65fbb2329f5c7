"""dsp/ domain — signal-processing modules.

Port of ``cyberether_tpu/blocks/dsp.py`` (so far: ``window``, ``fft``,
``amplitude``, ``invert``, ``agc`` and ``squelch``).  Compute is plain
torch ops on the segment's device, except the ``fft`` block's provider
``pallas``, which runs the hand-written FFT kernel
(:func:`cyberether_tpu_torch.ops.kernels.fft_pallas`).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

import numpy as np
import torch

from cyberether_tpu_torch.core.block import simple_block
from cyberether_tpu_torch.core.module import Module, PASS_FLAG
from cyberether_tpu_torch.core.params import Field, Schema
from cyberether_tpu_torch.core.registry import register_block, \
    register_module
from cyberether_tpu_torch.core.tensor import SignalAxes, TensorSpec
from cyberether_tpu_torch.core.types import DataType, Taint, ValidationError
from cyberether_tpu_torch.ops import fftops, kernels
from cyberether_tpu_torch.ops.fastmath import approx_log10
from cyberether_tpu_torch.ops.windows import blackman


def resolve_signal_axes(spec: TensorSpec) -> SignalAxes:
    """The spec's signal axes, with rank-1 defaulting sample to axis 0."""
    axes = spec.axes
    if axes.sample is None and spec.rank == 1:
        axes = replace(axes, sample=0)
    return axes


def _require_sample_axis(spec: TensorSpec, who: str) -> int:
    axes = resolve_signal_axes(spec)
    if axes.sample is None:
        raise ValidationError(
            f"[{who}] input must carry sampleAxis metadata")
    return axes.sample


def _require_float_input(spec: TensorSpec) -> None:
    if spec.dtype not in (DataType.F32, DataType.CF32):
        raise ValidationError(f"unsupported input dtype {spec.dtype}")


# ---------------------------------------------------------------------------
# window — Blackman window generator, STATIC_OUTPUT
# ---------------------------------------------------------------------------
@register_module
class WindowModule(Module):
    module_type = "window"
    taints = Taint.STATIC_OUTPUT
    output_ports = ("window",)
    schema = Schema(Field("size", "int", 1024))

    def validate(self) -> None:
        if int(self.config["size"]) == 0:
            raise ValidationError("window size cannot be zero")

    def create(self) -> Dict[str, TensorSpec]:
        return {"window": TensorSpec((int(self.config["size"]),),
                                     DataType.CF32, self.device,
                                     SignalAxes(sample=0))}

    def apply(self, inputs, state):
        w = blackman(int(self.config["size"]),
                     device=self.device.torch_device)
        return {"window": w.to(torch.complex64)}, state


# ---------------------------------------------------------------------------
# fft — pocketfft-compatible, unnormalized both directions
# ---------------------------------------------------------------------------
@register_module
class FftModule(Module):
    module_type = "fft"
    taints = Taint.STATELESS
    input_ports = ("signal",)
    output_ports = ("signal",)
    schema = Schema(Field("forward", "bool", True),
                    Field("complexOutput", "bool", False))

    def validate(self) -> None:
        spec = self.input_specs["signal"]
        _require_float_input(spec)
        self._axis = _require_sample_axis(spec, "MODULE_FFT")

    def create(self) -> Dict[str, TensorSpec]:
        spec = self.input_specs["signal"]
        out_dtype = spec.dtype
        shape = list(spec.shape)
        if (spec.dtype == DataType.F32 and self.config["forward"]
                and self.config["complexOutput"]):
            out_dtype = DataType.CF32
            shape[self._axis] = shape[self._axis] // 2 + 1
        return {"signal": spec.with_shape(shape).with_dtype(out_dtype)}

    def apply(self, inputs, state):
        x = inputs["signal"]
        fwd = bool(self.config["forward"])
        if x.is_complex():
            out = fftops.fft_c2c(x, self._axis, fwd)
        elif fwd and self.config["complexOutput"]:
            out = fftops.fft_r2c(x, self._axis)
        else:
            out = fftops.fft_r2r_fftpack(x, self._axis, fwd)
        return {"signal": out}, state


def fft_pallas_eligible(spec: TensorSpec, axis: int) -> bool:
    """Shapes the pallas FFT provider takes: CF32 with n = m*128, m a
    power of two <= 32 (composites use this to pick the provider)."""
    return spec.dtype == DataType.CF32 and \
        not kernels.k2_cuda_unsupported(spec.shape[axis])


@register_module
class FftPallasModule(FftModule):
    """fft with provider='pallas': the hand-written radix-2 FFT kernel
    (:func:`~cyberether_tpu_torch.ops.kernels.fft_pallas`) on the card,
    its plain version on the CPU; e.g. (4096, 2048) CF32.  Inverse
    transforms ride the conjugation identity n ifft(x) =
    conj(fft(conj(x))), unnormalized like the generic provider."""

    provider = "pallas"

    def validate(self) -> None:
        super().validate()
        spec = self.input_specs["signal"]
        if spec.dtype != DataType.CF32:
            raise ValidationError(
                "pallas provider supports CF32 transforms")
        if not fft_pallas_eligible(spec, self._axis):
            raise ValidationError(
                f"pallas provider needs n = m*128, m a power of two "
                f"<= 32 (got n={spec.shape[self._axis]})")

    def apply(self, inputs, state):
        # the kernel reads rows by pointer: the sample axis last, the
        # memory contiguous, any conjugation physical
        x = torch.movedim(inputs["signal"], self._axis, -1).contiguous() \
            .resolve_conj()
        if self.config["forward"]:
            out = kernels.fft_pallas(x)
        else:
            out = torch.conj_physical(
                kernels.fft_pallas(torch.conj_physical(x)))
        return {"signal": torch.movedim(out, -1, self._axis)}, state


# ---------------------------------------------------------------------------
# amplitude — |x| -> dB with a 1/N normalization offset
# ---------------------------------------------------------------------------
@register_module
class AmplitudeModule(Module):
    module_type = "amplitude"
    taints = Taint.STATELESS
    input_ports = ("signal",)
    output_ports = ("signal",)
    schema = Schema(Field("fastMath", "bool", False))

    def validate(self) -> None:
        spec = self.input_specs["signal"]
        _require_float_input(spec)
        axes = resolve_signal_axes(spec)
        if axes.sample is None and axes.channel is None:
            raise ValidationError(
                "input must contain sampleAxis or channelAxis metadata")
        self._norm = spec.shape[axes.sample] if axes.sample is not None \
            else 1

    def create(self) -> Dict[str, TensorSpec]:
        return {"signal": self.input_specs["signal"]
                .with_dtype(DataType.F32)}

    def apply(self, inputs, state):
        coeff = 20.0 * np.log10(1.0 / self._norm)
        mag = inputs["signal"].abs()
        zero = mag == 0.0
        safe = torch.where(zero, 1.0, mag)
        # fastMath: the reference's ApproxLog10 numerics (~8e-3 dB, no
        # transcendental)
        log10 = approx_log10(safe) if self.config["fastMath"] \
            else torch.log10(safe)
        out = torch.where(zero, -torch.inf, 20.0 * log10 + coeff)
        return {"signal": out.to(torch.float32)}, state


# ---------------------------------------------------------------------------
# invert — spectrum inversion: multiply by (-1)^k along the sample axis
# (odd lengths use the integer-bin phasor)
# ---------------------------------------------------------------------------
@register_module
class InvertModule(Module):
    module_type = "invert"
    taints = Taint.STATELESS
    input_ports = ("signal",)
    output_ports = ("signal",)

    def validate(self) -> None:
        spec = self.input_specs["signal"]
        _require_float_input(spec)
        self._axis = _require_sample_axis(spec, "MODULE_INVERT")
        n = spec.shape[self._axis]
        k = np.arange(n)
        if n % 2 == 0:
            pr = np.where(k % 2 == 0, 1.0, -1.0).astype(np.float32)
            pi = np.zeros(n, np.float32)
        else:
            phase = 2.0 * np.pi * (n // 2) * k / n
            pr = np.cos(phase).astype(np.float32)
            pi = np.sin(phase).astype(np.float32)
        shape = [1] * spec.rank
        shape[self._axis] = n
        self._phasor = torch.complex(torch.from_numpy(pr),
                                     torch.from_numpy(pi)) \
            .reshape(shape).to(self.device.torch_device)

    def create(self) -> Dict[str, TensorSpec]:
        return {"signal":
                self.input_specs["signal"].with_dtype(DataType.CF32)}

    def apply(self, inputs, state):
        x = inputs["signal"].to(torch.complex64)
        return {"signal": x * self._phasor}, state


# ---------------------------------------------------------------------------
# agc — tiled RMS AGC with slew-limited gain interpolation
# ---------------------------------------------------------------------------
@register_module
class AgcModule(Module):
    module_type = "agc"
    taints = Taint.STATELESS
    input_ports = ("signal",)
    output_ports = ("signal",)
    schema = Schema(
        Field("tileSize", "int", 1024),
        Field("reference", "float", 1.0),
        Field("epsilon", "float", 1e-12),
        Field("minGain", "float", 0.01),
        Field("maxGain", "float", 100.0),
        Field("maxGainChange", "float", 4.0))

    def validate(self) -> None:
        spec = self.input_specs["signal"]
        _require_float_input(spec)
        if int(self.config["tileSize"]) == 0:
            raise ValidationError("tileSize cannot be zero")
        self._axis = _require_sample_axis(spec, "MODULE_AGC")

    def create(self) -> Dict[str, TensorSpec]:
        return {"signal": self.input_specs["signal"]}

    def apply(self, inputs, state):
        x = inputs["signal"]
        n = x.shape[self._axis]
        tile = min(int(self.config["tileSize"]), n)
        ref = float(self.config["reference"])
        eps = float(self.config["epsilon"])
        gmin = float(self.config["minGain"])
        gmax = float(self.config["maxGain"])
        gchg = float(self.config["maxGainChange"])

        xt = torch.movedim(x, self._axis, -1)
        lanes = xt.shape[:-1]
        flat = xt.reshape(-1, n)
        power = flat.to(torch.complex64).abs() ** 2

        ntiles = 1 + (n - 1) // tile
        # per-tile mean power (the last tile may be shorter)
        gains = [(ref / torch.sqrt(power[:, t * tile:(t + 1) * tile]
                                   .mean(-1) + eps)).clamp(gmin, gmax)
                 for t in range(ntiles)]
        # the slew-limit chain runs tile after tile
        gain_dtype = torch.complex64 if x.is_complex() else torch.float32
        start = gains[0]
        out_rows = []
        for t in range(ntiles):
            s = t * tile
            ln = min(tile, n - s)
            if t + 1 < ntiles:
                lo = torch.clamp(start / gchg, min=gmin)
                hi = torch.where(start > gmax / gchg, gmax, start * gchg)
                end = torch.minimum(torch.maximum(gains[t + 1], lo), hi)
            else:
                end = start
            step = (end - start) / ln
            idx = torch.arange(ln, dtype=torch.float32, device=x.device)
            g = start[:, None] + step[:, None] * idx[None, :]
            out_rows.append(flat[:, s:s + ln] * g.to(gain_dtype))
            start = end
        out = torch.cat(out_rows, dim=-1).reshape(lanes + (n,))
        return {"signal": torch.movedim(out, -1, self._axis)
                .to(x.dtype)}, state


# ---------------------------------------------------------------------------
# squelch — peak-amplitude gate publishing metrics and a SKIP flag
# (a validity flag here)
# ---------------------------------------------------------------------------
@register_module
class SquelchModule(Module):
    module_type = "squelch"
    taints = Taint.STATELESS
    input_ports = ("signal",)
    output_ports = ("signal",)
    schema = Schema(Field("threshold", "float", 0.1))

    def validate(self) -> None:
        _require_float_input(self.input_specs["signal"])

    def create(self) -> Dict[str, TensorSpec]:
        return {"signal": self.input_specs["signal"]}

    def apply(self, inputs, state):
        x = inputs["signal"]
        peak = x.abs().amax()
        passing = peak > float(self.config["threshold"])
        return {"signal": x, PASS_FLAG: passing,
                "metric:passing": passing,
                "metric:amplitude": peak}, state


for _type in ("window", "fft", "amplitude", "invert", "agc", "squelch"):
    register_block(simple_block(_type))
