"""The model entry points' JAX keywords in the port, against the JAX
package on the CPU: ``Channelizer.step_kernel``'s ``decim_mode`` and
``atan_mode`` (JAX ``step_pallas_v4``, its Pallas kernels in interpret
mode), and ``SpectrumPipeline.step_dft_kernel``'s ``bf16`` (JAX
``step_pallas``).

Inputs: the channelizer's ``make_input_full`` (every channel occupied),
never ``make_input``, whose empty channels demodulate to atan-branch
noise.

Tolerances, and why:
- 1e-4 against JAX's ``atan_mode="recip"`` (the exact tier: a 5-term
  atan2 with a Newton step after the reciprocal);
- against every other ``atan_mode``, 2e-3 classic and 6e-3 coherent at
  D = 16: JAX's approximate reciprocal runs on the CPU as a bfloat16
  divide (relative error up to 3.4e-3) with no Newton step after it,
  while the port divides in fp32;
- the bf16 display tier: the 0.999 quantile of the error under 8e-3 and
  its max under 2e-2, JAX's own bars for that tier.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyberether_tpu.models import channelizer as jch
from cyberether_tpu.models.spectrum import SpectrumPipeline as JaxSpectrum
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.models import channelizer as tch
from cyberether_tpu_torch.models.spectrum import SpectrumPipeline

torch.set_num_threads(1)

C, P, D = 64, 8, 16
FRAMES = 1024                     # two of JAX's 512-frame tiles
EXACT_TOL = 1e-4
FAST_TOL = {"classic": 2e-3, "coherent": 6e-3}
# JAX's names, and two it does not name: one it runs through its packed
# layout ("...pack"), one through its plain 5-term atan2
ATAN_MODES = ["ypack", "spack", "fast3", "recip", "xpack", "poly5"]
CLASSIC = [(d, a) for d in ("chunk", "sel", "none") for a in ATAN_MODES]
COHERENT = [(d, a) for d in ("chunk", "sel") for a in ATAN_MODES
            if a != "xpack"]


@pytest.fixture(scope="module")
def pair():
    kw = {"channels": C, "taps_per_branch": P, "audio_decim": D,
          "sample_rate": C * 2e6}
    j = jch.Channelizer(**kw)
    t = tch.Channelizer(device="cpu", **kw)
    return j, t, j.make_input_full(FRAMES, seed=7)


def _both(pair, **kw):
    j, t, iq = pair
    ref, rst = j.step_pallas_v4(j.init_state_v4(), jnp.asarray(iq),
                                interpret=True, **kw)
    got, gst = t.step_kernel(t.init_state_v4(), torch.from_numpy(iq), **kw)
    np.testing.assert_array_equal(gst["hist"].numpy(), np.asarray(rst["hist"]))
    assert got.shape == (FRAMES // D, C) and got.dtype == torch.float32
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


@pytest.mark.parametrize("decim_mode,atan_mode", CLASSIC)
def test_step_kernel_classic_modes_match_jax(pair, decim_mode, atan_mode):
    err = _both(pair, decim_mode=decim_mode, atan_mode=atan_mode)
    assert err <= (EXACT_TOL if atan_mode == "recip" else FAST_TOL["classic"])


@pytest.mark.parametrize("decim_mode,atan_mode", COHERENT)
def test_step_kernel_coherent_modes_match_jax(pair, decim_mode, atan_mode):
    err = _both(pair, decim_mode=decim_mode, atan_mode=atan_mode,
                demod_mode="coherent")
    assert err <= (EXACT_TOL if atan_mode == "recip"
                   else FAST_TOL["coherent"])


@pytest.mark.parametrize("kernel,decim_mode", [
    ("v4", "chunk"), ("v4", "none"), ("v6", "sel"), ("v6", "none")])
def test_step_kernel_routes_take_decim_mode(pair, kernel, decim_mode):
    """v4 and v6 decimate in their kernels whatever ``decim_mode`` says,
    as JAX's do (JAX's v6 maps "sel" to "chunk")."""
    assert _both(pair, kernel=kernel, decim_mode=decim_mode,
                 atan_mode="recip") <= EXACT_TOL


def test_decim_none_is_the_undecimated_demod_meaned(pair):
    """decim_mode="none" runs the kernel at decimation 1 and means the
    demod over D frames: the decimated kernel's function."""
    _, t, iq = pair
    x = torch.from_numpy(iq)
    none, _ = t.step_kernel(t.init_state_v4(), x, decim_mode="none")
    sel, _ = t.step_kernel(t.init_state_v4(), x, decim_mode="sel")
    assert float((none - sel).abs().max()) <= 1e-6


def test_every_atan_mode_runs_the_one_kernel(pair):
    """An unnamed ``atan_mode`` runs in JAX (a 5-term atan2 on a raw
    reciprocal); in the port every value gives the same bits."""
    _, t, iq = pair
    x = torch.from_numpy(iq)
    want, _ = t.step_kernel(t.init_state_v4(), x)
    for mode in ATAN_MODES:
        got, _ = t.step_kernel(t.init_state_v4(), x, atan_mode=mode)
        assert torch.equal(got, want), mode


@pytest.mark.parametrize("kernel,decim_mode", [
    ("v5", "none"), ("v5", "big"), ("v4", "chunk"), ("v6", "sel")])
def test_coherent_checks_raise_as_in_jax(pair, kernel, decim_mode):
    j, t, iq = pair
    iq = iq[:512]
    with pytest.raises(ValueError, match="coherent"):
        j.step_pallas_v4(j.init_state_v4(), jnp.asarray(iq), interpret=True,
                         kernel=kernel, decim_mode=decim_mode,
                         demod_mode="coherent")
    with pytest.raises(ValueError, match="coherent"):
        t.step_kernel(t.init_state_v4(), torch.from_numpy(iq),
                      kernel=kernel, decim_mode=decim_mode,
                      demod_mode="coherent")


def test_unknown_v5_decim_mode_raises(pair):
    """JAX's v5 fails on a decimation mode it does not name (its body
    reaches for a selector it never built); the port says why."""
    j, t, iq = pair
    iq = iq[:512]
    with pytest.raises(Exception):
        j.step_pallas_v4(j.init_state_v4(), jnp.asarray(iq), interpret=True,
                         decim_mode="big")
    with pytest.raises(ValueError, match="decim_mode"):
        t.step_kernel(t.init_state_v4(), torch.from_numpy(iq),
                      decim_mode="big")
    with pytest.raises(TypeError, match="atan_mode"):
        t.step_kernel(t.init_state_v4(), torch.from_numpy(iq), atan_mode=3)


# -- SpectrumPipeline.step_dft_kernel(bf16=...) ---------------------------------

@pytest.mark.parametrize("n", [384, 2048])
@pytest.mark.parametrize("bf16", [False, True])
def test_step_dft_kernel_takes_bf16(n, bf16):
    """Both tiers run the fp32 K6; each stays within JAX's bars for its
    bf16 tier, on JAX's broadband input for that tier."""
    kw = {"use_mxu_fft": False, "fast_math": False}
    j = JaxSpectrum(fft_size=n, batches=8, **kw)
    t = SpectrumPipeline(fft_size=n, batches=8, device="cpu", **kw)
    t.load_params(convert.spectrum_params_from_arrays(
        {"win": np.asarray(j._win), "coeff": j._coeff, "scale": j._scale,
         "offset": j._offset}, device="cpu"))
    rng = np.random.default_rng(n)
    iq = (0.3 * rng.standard_normal((8, n, 2))).astype(np.float32)
    ref = np.asarray(j.step_pallas(jnp.asarray(iq), bf16=True,
                                   interpret=True))
    x = torch.from_numpy(iq)
    got = t.step_dft_kernel(x, bf16=bf16)
    assert torch.equal(got, t.step_dft_kernel(x))
    err = np.abs(got.numpy() - ref)
    assert np.quantile(err, 0.999) < 8e-3 and err.max() < 2e-2
