"""K1 and K9 on the tensor-core template of
``csrc/channelize_demod_decim.cu``, held before the card: a model of its
sums (``tf32x3_matmul`` below: each operand split into hi = tf32(v) and
lo = tf32(v - hi), three float32 products) against the plain versions and
the JAX package's ``channelize_demod_decim_v5`` and ``_v6``, run in
interpret mode as ``tests/test_torch_kernels.py`` and
``tests/test_torch_channelizer_routes.py`` run them; the planner's mirrors
of the source's constants; the channelizer rows' bounds of
``chip_smoke.py``.

Tolerances: 1e-4 on the audio (the exact tier); the model lands within
~1e-6 of the plain versions and ~3e-5 of JAX (the 3-term atan2 against
JAX's 5-term one, and JAX's bf16 reciprocal in interpret mode for K9).
One TF32 product alone misses the bar by 2x or more (2e-4 .. 1.4e-3), so
a kernel that skipped the lo terms could not pass the card's 1e-4.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyberether_tpu.models.channelizer import Channelizer as JaxChannelizer
from cyberether_tpu_torch.ops import kernels as tk
from cyberether_tpu_torch.ops.probe_kernels import tf32_round

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "cyberether_tpu_torch" / "csrc" /
       "channelize_demod_decim.cu").read_text()
SHAPES = [(8, 4, 4), (32, 8, 16), (64, 8, 16)]
FRAMES = 1024                      # two of JAX's 512-frame tiles
TOL = 1e-4


def _case(C, P, D, dtype, seed=0):
    """The JAX model, the frames and a non-zero history (quantized to
    ``dtype``'s full range for integer ingest), and the port's tables."""
    jm = JaxChannelizer(channels=C, taps_per_branch=P, audio_decim=D,
                        sample_rate=C * 2e6)
    iq = jm.make_input_full(FRAMES, seed=seed)
    prev = jm.make_input_full(P, seed=seed + 7)
    if dtype != np.float32:
        full = float(np.iinfo(dtype).max)
        s = full / np.abs(iq).max()
        iq = np.clip(np.round(iq * s), -full, full).astype(dtype)
        prev = np.clip(np.round(prev * s), -full, full).astype(dtype)
    hist = prev.reshape(P, 2 * C)
    args = (torch.from_numpy(iq.reshape(FRAMES, 2 * C)),
            torch.from_numpy(hist), torch.from_numpy(np.array(jm._hp5)),
            torch.from_numpy(np.array(jm._bperm5)), float(jm._fm_ref), D)
    return jm, iq, hist, args


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor,
                  terms: int = 3) -> torch.Tensor:
    """a @ b in float32 as the tensor-core template sums it: each operand
    split into hi = tf32(v) and lo = tf32(v - hi), and lo(a) hi(b) +
    hi(a) lo(b) + hi(a) hi(b) as three float32 products (``terms=1``:
    hi(a) hi(b) alone, one TF32 product).  A model of the kernel's
    arithmetic, not a plain version: the order of its float32 sums is not
    the card's."""
    ah, bh = tf32_round(a), tf32_round(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def tf32_model(x2, hist, hp, bperm, fm_ref, decim, demod_mode="classic",
               poly3=True, terms=3):
    """K1's function (``poly3``; K9's with ``poly3=False``, a true
    division for its refined reciprocal) with the DFT summed by
    :func:`tf32x3_matmul` (``terms`` products): the FIR over [hist | x]
    for frames -1 .. M-1, the product, then the plain version's lag
    products, atan2 and boxcar."""
    M = x2.shape[0]
    ext = torch.cat([hist.float(), x2.float()])
    z = ext[0:M + 1] * hp[0]
    for p in range(1, hp.shape[0]):
        z = z + ext[p:p + M + 1] * hp[p]
    y = tf32x3_matmul(z, bperm, terms)
    return tk._decimated_demod(y, fm_ref, decim, demod_mode, poly3=poly3)


def _err(got: torch.Tensor, ref) -> float:
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("mode", ["classic", "coherent"])
@pytest.mark.parametrize("C,P,D", SHAPES)
def test_k1_model_matches_plain_and_jax(C, P, D, mode, dtype):
    jm, iq, hist, args = _case(C, P, D, dtype)
    model = tf32_model(*args, mode)
    plain = tk.channelize_demod_decim_plain(*args, mode)
    ref, _ = jm.step_pallas_v4({"hist": jnp.asarray(hist)}, jnp.asarray(iq),
                               tile_m=512, interpret=True,
                               atan_mode="recip", decim_mode="sel",
                               demod_mode=mode)
    assert model.shape == (FRAMES // D, C)
    assert float((model - plain).abs().max()) <= TOL
    assert _err(model, ref) <= TOL


@pytest.mark.parametrize("C,P,D", SHAPES)
def test_k9_model_matches_plain_and_jax(C, P, D):
    jm, iq, _, args = _case(C, P, D, np.float32, seed=1)
    args = (args[0], torch.zeros_like(args[1])) + args[2:]
    model = tf32_model(*args, poly3=False)
    plain = tk.channelize_demod_decim_v6_plain(*args)
    ref, _ = jm.step_pallas_v4(jm.init_state_v4(), jnp.asarray(iq),
                               interpret=True, kernel="v6")
    assert float((model - plain).abs().max()) <= TOL
    assert _err(model, ref) <= TOL


@pytest.mark.parametrize("mode", ["classic", "coherent"])
@pytest.mark.parametrize("C,P,D", SHAPES)
def test_one_tf32_product_misses_the_bar(C, P, D, mode):
    """Without the lo terms the DFT keeps ~3 decimal digits, and the audio
    lands past 1e-4 of the plain version at every shape."""
    _, _, _, args = _case(C, P, D, np.float32)
    plain = tk.channelize_demod_decim_plain(*args, mode)
    one = tf32_model(*args, mode, terms=1)
    assert float((one - plain).abs().max()) > 1.5 * TOL


def test_k9_one_tf32_product_misses_the_bar():
    _, _, _, args = _case(64, 8, 16, np.float32, seed=1)
    plain = tk.channelize_demod_decim_v6_plain(*args)
    one = tf32_model(*args, poly3=False, terms=1)
    assert float((one - plain).abs().max()) > 1.5 * TOL


def test_tf32x3_matmul_is_fp32_grade():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((300, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    truth = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(truth).max()
    three = tf32x3_matmul(torch.from_numpy(a), torch.from_numpy(b))
    one = tf32x3_matmul(torch.from_numpy(a), torch.from_numpy(b), terms=1)
    assert np.abs(three.numpy() - truth).max() <= 2e-6 * scale
    assert np.abs(one.numpy() - truth).max() > 1e-4 * scale


def test_planner_constants_are_the_launchers():
    """The Python mirrors of the tensor-core template's constants, read
    from the source; the C that run it; the instances ``k1_instance``
    names."""

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", SRC)
                   .group(1))

    assert tk.K1_TILE_FRAMES == const("kTcTile") == 64
    assert "constexpr int kTcChunk = 2 * kTcTile;" in SRC
    assert 2 * tk.K1_TILE_FRAMES == tk.K1_BLOCK_FRAMES
    assert const("kTcThreads") == 4 * 128            # four warpgroups
    assert tk.K1_MAX_TAPS == const("kMaxTaps")
    # every C the kernel takes runs the tensor-core template
    body = SRC.split("cudaError_t launch_decim(int C")[1].split("\n}\n")[0]
    assert re.findall(r"case (\d+):  ?return launch_tc<Tin, \1, A>", body) \
        == [str(c) for c in tk.K1_CHANNELS]
    assert "channelize_tc_kernel(const Tin* __restrict__ x" in SRC
    assert "enum Atan { kPoly3Div = 0, kPoly5Div = 1, kPoly5Rcp = 2 };" \
        in SRC
    assert tk.k1_instance(64) == "channelize_tc_kernel<float,64,0,0>"
    assert tk.k1_instance(8, torch.int8) == \
        "channelize_tc_kernel<schar,8,0,0>"
    assert tk.k1_instance(32, torch.int16, "poly5rcp") == \
        "channelize_tc_kernel<short,32,2,0>"
    # K1 and K9 dispatch through the tensor-core launcher
    for symbol, call in (("channelize_demod_decim_launch",
                          "launch_decim<float, kPoly3Div>"),
                         ("channelize_demod_decim_v6_launch",
                          "launch_decim<float, kPoly5Rcp>")):
        body = SRC.split(f'extern "C" int {symbol}(')[1].split("\n}\n")[0]
        assert call in body


def ptxas_instance(kernel: str, registers: int):
    """(instance name, [registers, spill bytes]) as ``ab_spectrum`` reads
    them from ptxas's report of one entry function: ``kernel`` mangled,
    behind the anonymous namespace's per-build prefix."""
    sys.path.insert(0, str(ROOT))
    import ab_spectrum

    mangled = ("_ZN47_GLOBAL__N__1a2b3c4d_20_channelize_demod_cu_5e6f7a8b20"
               + kernel)
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\nptxas info    : Used {registers} registers, 0 bytes "
           "spill stores, 0 bytes spill loads\n")
    (key, usage), = ab_spectrum.ptxas(log).items()
    return ab_spectrum.instance_name(key), usage


def test_k1_instance_names_are_ptxas_names():
    assert ptxas_instance("channelize_tc_kernelIaLi64ELi0ELi0EEEvPKT_",
                          128) == (tk.k1_instance(64, torch.int8), [128, 0])


def test_channelizer_bounds_count_the_dft_on_the_tensor_cores():
    """K1 at full width: three TF32 products (12.9 GFLOP at 495 TFLOP/s)
    set 0.0260 ms; the FIR, lag, atan2 and boxcar (0.46 GFLOP fp32) and
    the 69.3 MB of HBM less.  The bound before counted one product at the
    fp32 FFMA peak: 0.0710 ms."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    M, C, P, D = cs.M, cs.C, cs.P, cs.D
    ms, by, work = cs.k1_bound_ms(M, C, P, D, 4, coherent=False)
    assert (round(ms, 4), by) == (0.026, "operations")
    assert work["ops"]["tf32"] == 3 * 2 * (M + 1) * (2 * C) ** 2
    assert work["ops"]["tf32"] / cs.PEAK_FLOPS["tf32"] > max(
        work["ops"]["fp32"] / cs.PEAK_FLOPS["fp32"],
        work["bytes"] / cs.HBM_BYTES_PER_S)
    assert round(cs.k1_bound_ms(M, C, P, D, 4, coherent=False,
                                dft="fp32")[0], 4) == 0.0710
    # K8 and K9: the same function; K7: undecimated, bound by its bytes
    k9 = cs.k1_bound_ms(M, C, P, D, 4, coherent=False,
                        atan_ops=cs.ATAN2_OPS5)
    assert round(k9[0], 4) == 0.026
    assert round(cs.k1_bound_ms(M, C, P, D, 4, coherent=False,
                                atan_ops=cs.ATAN2_OPS5, dft="fp32")[0],
                 4) == 0.0717
    k7 = cs.k7_bound_ms(M, C, P)
    assert (round(k7[0], 4), k7[1]) == (0.0301, "bytes")
    assert round(cs.k7_bound_ms(M, C, P, dft="fp32")[0], 4) == 0.0716
    # K16's stages: the product bounds each but full_rate, which writes
    # (M, 2C)
    for stage in tk.CHANNELIZE_ABLATE_INSTANCES:
        b = cs.k1_bound_ms(M, C, P, D, 4, coherent=False,
                           atan_ops=cs.ATAN2_OPS5, stage=stage)
        assert b[1] == ("bytes" if stage == "full_rate" else "operations")
        assert b[0] < cs.k1_bound_ms(M, C, P, D, 4, coherent=False,
                                     atan_ops=cs.ATAN2_OPS5, stage=stage,
                                     dft="fp32")[0]
    # the floor over measured rates takes the slowest pipe
    rates = {"tf32": 400e12, "fp32": 50e12}
    assert cs.floor_ms(work, 2.8e12, rates) == pytest.approx(
        work["ops"]["tf32"] / 400e12 * 1e3)
