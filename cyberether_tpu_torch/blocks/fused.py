"""Fused pipeline blocks — the flagship models as flowgraph citizens.

Port of ``cyberether_tpu/blocks/fused.py`` (so far: ``channelizer``,
``wbfm`` and ``spectrum``).  The modules register under provider ``pallas``, the name
flowgraph YAML files use for the fused-kernel path, so the same YAML
selects the hand-written CUDA kernels here.
"""

from __future__ import annotations

from typing import Dict

import torch

from cyberether_tpu_torch.core.block import simple_block
from cyberether_tpu_torch.core.module import Module
from cyberether_tpu_torch.core.params import Field, Schema
from cyberether_tpu_torch.core.registry import register_block, \
    register_module
from cyberether_tpu_torch.core.tensor import TensorSpec
from cyberether_tpu_torch.core.types import DataType, Device, Runtime, \
    ValidationError
from cyberether_tpu_torch.models.channelizer import Channelizer
from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
from cyberether_tpu_torch.models.wbfm import WbfmReceiver
from cyberether_tpu_torch.ops import kernels


@register_module
class ChannelizerFusedModule(Module):
    """(frames, C) channel-framed IQ -> (frames/decim, C) FM audio."""

    module_type = "channelizer"
    runtime = Runtime.KERNEL
    provider = "pallas"
    input_ports = ("buffer",)
    output_ports = ("audio",)
    schema = Schema(Field("tapsPerBranch", "int", 8),
                    Field("audioDecim", "int", 16),
                    Field("sampleRate", "float", 128e6),
                    Field("deviation", "float", 75e3),
                    Field("tileM", "int", 8192,
                          help="kept for YAML parity: the CUDA kernel "
                               "picks its own block size, and the output "
                               "does not depend on it"),
                    # classic: per-sample discriminator then boxcar
                    # (reference parity).  coherent: average the complex
                    # lag products, ONE angle per audio sample
                    Field("demodMode", "str", "classic"))

    def validate(self) -> None:
        if str(self.config["demodMode"]) not in ("classic", "coherent"):
            raise ValidationError(
                "demodMode must be 'classic' or 'coherent' "
                f"(got {self.config['demodMode']!r})")
        spec = self.input_specs["buffer"]
        if spec.dtype == DataType.CF32 and spec.rank == 2:
            self._complex_in = True
            frames, C = spec.shape
        elif spec.dtype == DataType.F32 and spec.rank == 3 \
                and spec.shape[-1] == 2:
            self._complex_in = False
            frames, C = spec.shape[:2]
        else:
            raise ValidationError(
                "channelizer input must be CF32 (frames, C) or F32 "
                f"(frames, C, 2); got {spec.dtype} {spec.shape}")
        D = int(self.config["audioDecim"])
        if frames % D:
            raise ValidationError(
                f"frames ({frames}) must divide audioDecim ({D})")
        P = int(self.config["tapsPerBranch"])
        if frames < P:
            raise ValidationError(
                f"frames ({frames}) must be at least tapsPerBranch ({P})")
        if self.device is Device.CUDA:
            problem = kernels.k1_cuda_unsupported(C, P, D)
            if problem:
                raise ValidationError(problem)
        self._model = Channelizer(
            channels=C, taps_per_branch=P, audio_decim=D,
            sample_rate=float(spec.attributes.get(
                "sampleRate", self.config["sampleRate"])),
            deviation=float(self.config["deviation"]),
            device=self.device.torch_device)
        self._frames = frames

    def create(self) -> Dict[str, TensorSpec]:
        m = self._model
        out_rate = m.sample_rate / m.channels / m.audio_decim
        return {"audio": TensorSpec(
            (self._frames // m.audio_decim, m.channels),
            DataType.F32, device=self.device,
            attributes={"sampleRate": out_rate})}

    def init_state(self):
        return self._model.init_state_v4()

    def apply(self, inputs, state):
        iq = inputs["buffer"]
        if self._complex_in:
            iq = torch.view_as_real(iq)      # (frames, C, 2), no copy
        audio, new_state = self._model.step_kernel(
            state, iq, demod_mode=str(self.config["demodMode"]))
        return {"audio": audio}, new_state


@register_module
class WbfmFusedModule(Module):
    """WBFM receiver: (n,) CF32 or (n, 2) F32 IQ -> (n / audioDecim,)
    audio, through channel FIR + discriminator in one kernel."""

    module_type = "wbfm"
    runtime = Runtime.KERNEL
    provider = "pallas"
    input_ports = ("buffer",)
    output_ports = ("audio",)
    schema = Schema(Field("sampleRate", "float", 2e6),
                    Field("channelBandwidth", "float", 200e3),
                    Field("audioDecim", "int", 40),
                    Field("taps", "int", 129),
                    Field("deviation", "float", 75e3),
                    Field("demodMode", "str", "classic"))

    def validate(self) -> None:
        spec = self.input_specs["buffer"]
        if spec.dtype == DataType.CF32 and spec.rank == 1:
            self._complex_in = True
        elif spec.dtype == DataType.F32 and spec.rank == 2 \
                and spec.shape[-1] == 2:
            self._complex_in = False
        else:
            raise ValidationError(
                "wbfm input must be CF32 (n,) or F32 (n, 2); got "
                f"{spec.dtype} {spec.shape}")
        n = spec.shape[0]
        D = int(self.config["audioDecim"])
        if D < 1 or n % 128 or n % D:
            raise ValidationError(
                f"wbfm length ({n}) must be a multiple of 128 and of "
                f"audioDecim ({D})")
        if not 1 < int(self.config["taps"]) <= kernels.WBFM_MAX_TAPS:
            raise ValidationError(
                f"taps must be in (1, {kernels.WBFM_MAX_TAPS}]")
        mode = str(self.config["demodMode"])
        if mode not in ("classic", "coherent"):
            raise ValidationError(
                f"demodMode must be 'classic' or 'coherent' (got {mode!r})")
        if mode == "coherent":
            problem = kernels.wbfm_coherent_unsupported(D)
            if problem:
                raise ValidationError(problem)
        self._rx = WbfmReceiver(
            sample_rate=float(spec.attributes.get(
                "sampleRate", self.config["sampleRate"])),
            channel_bw=float(self.config["channelBandwidth"]),
            audio_decim=D,
            taps=int(self.config["taps"]),
            deviation=float(self.config["deviation"]),
            device=self.device.torch_device)
        self._n = n

    def create(self) -> Dict[str, TensorSpec]:
        rx = self._rx
        return {"audio": TensorSpec(
            (self._n // rx.audio_decim,), DataType.F32, device=self.device,
            attributes={"sampleRate": rx.sample_rate / rx.audio_decim})}

    def init_state(self):
        return self._rx.init_state()

    def apply(self, inputs, state):
        iq = inputs["buffer"]
        if self._complex_in:
            iq = torch.view_as_real(iq)      # (n, 2), no copy
        audio, new_state = self._rx.step_kernel(
            state, iq, demod_mode=str(self.config["demodMode"]))
        return {"audio": audio}, new_state


@register_module
class SpectrumFusedModule(Module):
    """(B, n) CF32 or (B, n, 2) F32 IQ -> (B, n) spectrum in [0, 1]:
    window + FFT + |.|^2 dB + range scale + soft clip in one kernel."""

    module_type = "spectrum"
    runtime = Runtime.KERNEL
    provider = "pallas"
    input_ports = ("buffer",)
    output_ports = ("spectrum",)
    schema = Schema(Field("rangeMin", "float", -100.0),
                    Field("rangeMax", "float", 0.0),
                    Field("bf16", "bool", False,
                          help="kept for YAML parity: it picks a precision "
                               "tier, and every tier runs the same fp32 "
                               "kernel here"),
                    Field("algorithm", "str", "auto"),
                    # the precision tiers of the JAX package's ct path
                    # (MXU pass counts) all run the same fp32 kernel here
                    Field("precision", "str", ""))

    def validate(self) -> None:
        spec = self.input_specs["buffer"]
        if spec.dtype == DataType.CF32 and spec.rank == 2:
            self._complex_in = True
            B, n = spec.shape
        elif spec.dtype == DataType.F32 and spec.rank == 3 \
                and spec.shape[-1] == 2:
            self._complex_in = False
            B, n = spec.shape[:2]
        else:
            raise ValidationError(
                "spectrum input must be CF32 (B, n) or F32 (B, n, 2); "
                f"got {spec.dtype} {spec.shape}")
        if n > 128 and n % 128:
            raise ValidationError(
                f"fft size ({n}) must be a multiple of 128")
        algo = str(self.config["algorithm"])
        if algo not in ("auto", "ct", "dft"):
            raise ValidationError(
                f"algorithm must be auto/ct/dft, got {algo}")
        # ct: K2 (m a power of two) or K5 (any other m <= 32); otherwise,
        # or with algorithm dft, the full DFT, K6
        ct_ok = n % 128 == 0 and n // 128 <= kernels.CT_MAX_CHUNKS
        self._use_ct = algo == "ct" or (algo == "auto" and ct_ok)
        prec = str(self.config["precision"])
        if prec not in ("", "exact", "accurate", "display"):
            raise ValidationError(
                "precision must be exact/accurate/display "
                f"(got {prec!r})")
        if prec and not self._use_ct:
            raise ValidationError(
                "precision tiers are a property of the ct path; "
                f"algorithm={algo!r} with this fft size does not "
                "take it (precision rides the bf16 knob there)")
        if algo == "ct" and not ct_ok:
            raise ValidationError(
                f"algorithm=ct needs fft size = m*128, m<=32 (got {n})")
        self._pipe = SpectrumPipeline(
            fft_size=n, batches=B,
            range_min=float(self.config["rangeMin"]),
            range_max=float(self.config["rangeMax"]),
            device=self.device.torch_device)
        self._shape = (B, n)

    def create(self) -> Dict[str, TensorSpec]:
        return {"spectrum": TensorSpec(self._shape, DataType.F32,
                                       device=self.device)}

    def apply(self, inputs, state):
        iq = inputs["buffer"]
        if self._complex_in:
            iq = torch.view_as_real(iq)      # (B, n, 2), no copy
        step = self._pipe.step_kernel if self._use_ct \
            else self._pipe.step_dft_kernel
        return {"spectrum": step(iq)}, state


for _type, _summary in (
        ("channelizer", "fused polyphase channelizer + FM demod"),
        ("wbfm", "fused WBFM receiver (FIR + discriminator + decim)"),
        ("spectrum", "fused spectrum (window + FFT + dB + range)")):
    register_block(simple_block(_type, summary=_summary))
