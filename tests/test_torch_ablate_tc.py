"""K16 (``channelize_ablate``) on K1's tensor-core template of
``csrc/channelize_demod_decim.cu``, held before the card: a model of each
stage's sums on that template (its products by ``tf32x3_matmul`` of
``tests/test_torch_channelizer_tc.py``: each operand split into
hi = tf32(v) and lo = tf32(v - hi), three float32 products) against the
plain version ``channelize_ablate_plain`` and the TPU ablation's bodies
(``tools/ablation/chan_ablate.py``'s ``make_call`` with ``k_full`` ..
``k_fullrate``, taken with ``ast`` and run in interpret mode as
``tests/test_torch_ablate.py`` runs them); the instance names against the
source's launch switch.

Tolerances, the card's bars: angles (the stages that take an atan2)
1e-4 absolute; every other output, ``full_rate``'s dr half too, 1e-5 of
its max|o|.  One TF32 product alone misses each stage's bar, so a kernel
that dropped the lo terms could not pass on the card.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyberether_tpu.models import channelizer as jch
from cyberether_tpu_torch.ops import kernels as tk
from test_torch_ablate import ANGLE_TOL, CHAN_BODIES, REL_TOL, _bodies
from test_torch_channelizer_tc import ptxas_instance, tf32x3_matmul

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "cyberether_tpu_torch" / "csrc" /
       "channelize_demod_decim.cu").read_text()
SHAPES = [(8, 4, 4), (64, 8, 16)]     # (C, P, D): the card's two shapes
TM, FRAMES = 64, 256                  # the TPU bodies' tile, and 4 tiles
ANGLE_STAGES = ("full", "no_fir", "reshape_mean")
# the source's Stage of each instance
STAGE_ENUM = {"full": "kFull", "no_fir": "kNoFir", "no_atan": "kNoAtan",
              "no_demod": "kNoDemod", "matmul_only": "kMatmulOnly",
              "full_rate": "kFullRate"}
# the source's Stage enum (name -> value) and kPoly5Div's value
ENUM = dict(re.findall(r"(k\w+) = (\d+)",
                       re.search(r"enum Stage \{([^}]*)\}", SRC).group(1)))
ATAN = re.search(r"kPoly5Div = (\d+)", SRC).group(1)


def k16_model(x2, hist, hp, b, gain: float, decim: int, stage: str,
              terms: int = 3) -> torch.Tensor:
    """``channelize_ablate_plain``'s function with each product summed as
    the tensor-core template sums it (:func:`tf32x3_matmul`, ``terms``
    products): z from the FIR over ext = [hist | x2] (``no_fir``: ext
    itself; ``matmul_only``: x2 alone), then the plain version's lag
    products, 5-term atan2 and boxcar."""
    M, C = x2.shape[0], x2.shape[1] // 2
    g = float(np.float32(gain))
    if stage == "matmul_only":
        return tk._boxcar(tf32x3_matmul(x2, b, terms)[:, :C], decim)
    ext = torch.cat([hist, x2])
    if stage == "no_fir":
        z = ext[:M + 1]
    else:
        z = ext[0:M + 1] * hp[0]
        for p in range(1, hp.shape[0]):
            z = z + ext[p:p + M + 1] * hp[p]
    y = tf32x3_matmul(z, b, terms)
    if stage == "no_demod":
        return tk._boxcar(y[1:, :C] * g, decim)
    dr, di = tk._lag_products(y[:-1], y[1:])
    if stage == "no_atan":
        return tk._boxcar(di * g, decim)
    angle = tk.atan2_poly(di, dr, poly3=False) * g
    if stage == "full_rate":
        return torch.cat([angle, dr], dim=1)
    return tk._boxcar(angle, decim)


def _errs(got, ref, stage: str, C: int) -> list:
    """(error, bar) of each part of the output: angles absolute, the rest
    of their max|o|; full_rate's two halves each by its own."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)

    def absolute(a, r):
        return float(np.abs(a - r).max()), ANGLE_TOL

    def relative(a, r):
        return float(np.abs(a - r).max() / np.abs(r).max()), REL_TOL

    if stage == "full_rate":
        return [absolute(got[:, :C], ref[:, :C]),
                relative(got[:, C:], ref[:, C:])]
    return [(absolute if stage in ANGLE_STAGES else relative)(got, ref)]


def _held(got, ref, stage: str, C: int) -> None:
    for err, bar in _errs(got, ref, stage, C):
        assert err <= bar, (stage, err, bar)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "C%d_P%d_D%d" % s)
def case(request):
    """The JAX model at (C, P, D), its tables as tensors, a full-band
    stream of P + FRAMES frames and the TPU bodies at that shape."""
    C, P, D = request.param
    j = jch.Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                        sample_rate=C * 2e6)
    frames = j.make_input_full(P + FRAMES).reshape(P + FRAMES, 2 * C)
    tables = (torch.from_numpy(np.array(j._hp5)),
              torch.from_numpy(np.array(j._bperm5)), float(j._fm_ref))
    bodies = _bodies("chan_ablate.py", ["make_call", *CHAN_BODIES.values()],
                     C=C, P=P, D=D, TM=TM, grid=FRAMES // TM,
                     gain=float(j._fm_ref))
    return (C, P, D), j, frames, tables, bodies


def _inputs(frames: np.ndarray, P: int, hist_kind: str):
    """(x2, hist): the last FRAMES frames, and zeros (the TPU script's
    first halo) or the P frames before them."""
    x2 = np.ascontiguousarray(frames[P:])
    hist = np.zeros((P, frames.shape[1]), np.float32) \
        if hist_kind == "zero" else np.ascontiguousarray(frames[:P])
    return x2, hist


def _jax(j, bodies, shape, stage: str, x2, hist) -> np.ndarray:
    """The TPU body of ``stage`` through the script's ``make_call``, its
    halos and selector built as the script builds them, halo 0 ``hist``."""
    _, P, D = shape
    idx = np.arange(1, FRAMES // TM)[:, None] * TM - P + np.arange(P)[None, :]
    halos = np.concatenate([hist[None], x2[idx]], 0)
    sel = np.kron(np.eye(TM // D, dtype=np.float32),
                  np.full((1, D), 1.0 / D, np.float32))
    out_rows = TM if stage == "full_rate" else TM // D
    call = bodies["make_call"](bodies[CHAN_BODIES[stage]], out_rows)
    return np.asarray(call(jnp.asarray(x2), jnp.asarray(halos),
                           j._hp5, j._bperm5, jnp.asarray(sel)))


@pytest.mark.parametrize("hist_kind", ["zero", "stream"])
@pytest.mark.parametrize("stage", list(CHAN_BODIES))
def test_k16_tc_model_matches_plain_and_jax(case, stage, hist_kind):
    shape, j, frames, tables, bodies = case
    C, P, D = shape
    x2, hist = _inputs(frames, P, hist_kind)
    args = (torch.from_numpy(x2), torch.from_numpy(hist), *tables, D, stage)
    model = k16_model(*args)
    plain = tk.channelize_ablate_plain(*args)
    want = (FRAMES, 2 * C) if stage == "full_rate" else (FRAMES // D, C)
    assert model.shape == plain.shape == want
    _held(model.numpy(), plain.numpy(), stage, C)
    _held(model.numpy(), _jax(j, bodies, shape, stage, x2, hist), stage, C)


@pytest.mark.parametrize("stage", tk.CHANNELIZE_ABLATE_INSTANCES)
def test_k16_one_tf32_product_misses_the_bar(case, stage):
    """Without the lo terms the product keeps ~3 decimal digits: each
    stage's output lands past its bar."""
    shape, _, frames, tables, _ = case
    C, P, D = shape
    x2, hist = _inputs(frames, P, "stream")
    args = (torch.from_numpy(x2), torch.from_numpy(hist), *tables, D, stage)
    one = k16_model(*args, terms=1)
    plain = tk.channelize_ablate_plain(*args)
    assert max(err / bar for err, bar in
               _errs(one.numpy(), plain.numpy(), stage, C)) > 1.5


def test_k16_instances_are_the_launch_switch():
    """Each stage's instance name is the tensor-core template's, at the
    source's Atan (kPoly5Div) and Stage values, and the C entry point
    switches every stage to it; the FFMA template has no Stage left.
    The source is read with its whitespace taken out."""
    src = re.sub(r"\s+", "", SRC)
    assert sorted(STAGE_ENUM.values()) == sorted(ENUM)
    for stage, inst in tk.CHANNELIZE_ABLATE_INSTANCE_OF.items():
        for c in tk.K16_CHANNELS:
            assert tk.k16_instance(c, stage) == (
                f"channelize_tc_kernel<float,{c},{ATAN},"
                f"{ENUM[STAGE_ENUM[inst]]}>")
    # the wrapper passes each instance's index as the C entry's stage
    assert [int(ENUM[STAGE_ENUM[i]]) for i in
            tk.CHANNELIZE_ABLATE_INSTANCES] == list(range(6))
    entry = src.split('extern"C"intchannelize_ablate_launch(')[1] \
        .split("}}")[0]
    assert re.findall(r"case(k\w+):return\(int\)launch_ablate<\1>"
                      r"\(C,a,s\);", entry) == list(STAGE_ENUM.values())
    body = src.split("cudaError_tlaunch_ablate(intC")[1].split("}}")[0]
    assert re.findall(r"case(\d+):returnlaunch_tc<float,\1,kPoly5Div,"
                      r"Stage>", body) == [str(c) for c in tk.K16_CHANNELS]
    assert "template<intC,boolFolded>__global__" in src
    assert "template<typenameTin,intC,intA,intStage=kFull>__global__" in src
    with pytest.raises(ValueError, match="stage"):
        tk.k16_instance(64, "k_full")


@pytest.mark.parametrize("C", tk.K16_CHANNELS)
@pytest.mark.parametrize("stage", tk.CHANNELIZE_ABLATE_INSTANCES)
def test_k16_instance_names_are_ptxas_names(stage, C):
    kernel = (f"channelize_tc_kernelIfLi{C}ELi{ATAN}"
              f"ELi{ENUM[STAGE_ENUM[stage]]}EEEvPKT_")
    assert ptxas_instance(kernel, 126) == (tk.k16_instance(C, stage),
                                           [126, 0])
