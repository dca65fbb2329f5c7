"""Composite blocks: blocks with no module of their own, built from other
modules.

Port of ``cyberether_tpu/blocks/composites.py`` (so far:
``spectrum_engine``).
"""

from __future__ import annotations

from cyberether_tpu_torch.blocks.dsp import fft_pallas_eligible, \
    resolve_signal_axes
from cyberether_tpu_torch.core.block import Block, BlockContext
from cyberether_tpu_torch.core.params import Field, Schema
from cyberether_tpu_torch.core.registry import register_block
from cyberether_tpu_torch.core.types import Device, ValidationError


# ---------------------------------------------------------------------------
# spectrum_engine: cast(CF32) -> window -> invert -> reshape -> multiply
#   -> fft -> [agc(tile=N)] -> amplitude -> [range]
# ---------------------------------------------------------------------------
@register_block
class SpectrumEngineBlock(Block):
    block_type = "spectrum_engine"
    summary = "Computes spectra with windowing, FFT, and optional scaling."
    input_ports = ("buffer",)
    output_ports = ("buffer",)
    schema = Schema(
        Field("enableAgc", "bool", False),
        Field("enableScale", "bool", False),
        Field("rangeMin", "float", -120.0),
        Field("rangeMax", "float", 0.0),
        Field("fastMath", "bool", False))

    def build(self, ctx: BlockContext) -> None:
        spec = ctx.input_spec("buffer")
        axis = resolve_signal_axes(spec).sample
        if axis is None:
            raise ValidationError(
                "[BLOCK_SPECTRUM_ENGINE] input must carry sampleAxis")
        n = spec.shape[axis]

        cast = ctx.module("cast_input", "cast", {"outputType": "CF32"},
                          {"buffer": ctx.input_ref("buffer")})
        win = ctx.module("window", "window", {"size": n})
        inv = ctx.module("invert", "invert", {}, {"signal": win["window"]})
        shape = [1] * spec.rank
        shape[axis] = n
        rsh = ctx.module("reshape_window", "reshape", {"shape": shape},
                         {"buffer": inv["signal"]})
        sax = ctx.module("axes_window", "signal_axes",
                         {"axes": f"sample={axis}"},
                         {"buffer": rsh["buffer"]})
        mul = ctx.module("multiply", "multiply", {},
                         {"a": cast["buffer"], "b": sax["buffer"]})
        # eligible transforms on the card run the FFT kernel; other
        # shapes, and a block on the CPU, keep the generic provider
        fft_in = ctx.resolve_spec(mul["product"])
        prov = "pallas" if (fft_pallas_eligible(fft_in, axis)
                            and self.device != Device.CPU) else None
        fft = ctx.module("fft", "fft", {"forward": True},
                         {"signal": mul["product"]}, provider=prov)
        tail = fft["signal"]
        if self.config["enableAgc"]:
            agc = ctx.module("agc", "agc", {"tileSize": n},
                             {"signal": tail})
            tail = agc["signal"]
        amp = ctx.module("amplitude", "amplitude",
                         {"fastMath": self.config["fastMath"]},
                         {"signal": tail})
        out = amp["signal"]
        if self.config["enableScale"]:
            rng = ctx.module("range", "range",
                             {"min": self.config["rangeMin"],
                              "max": self.config["rangeMax"]},
                             {"signal": out})
            out = rng["signal"]
        ctx.expose("buffer", out)
