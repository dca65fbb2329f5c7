"""The port's channelizer model (``cyberether_tpu_torch.models.channelizer``)
and ``convert.py`` against the JAX package's ``Channelizer``, on the CPU.

Tolerances: tables and synthetic inputs are bit-identical; ``step`` and
``step_kernel`` are held to 1e-4 of JAX's XLA ``step`` (the JAX tests'
bar for the exact path); a stream split in two matches the whole to
1e-5; carried history is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyberether_tpu.models import channelizer as jch
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.models import channelizer as tch

torch.set_num_threads(1)

CONFIGS = [(8, 4, 4), (16, 4, 4), (64, 8, 16)]


def _pair(C, P, D, **kw):
    kw.setdefault("sample_rate", C * 2e6)
    j = jch.Channelizer(channels=C, taps_per_branch=P, audio_decim=D, **kw)
    t = tch.Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                        device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("C,P,D", CONFIGS)
def test_tables_match_jax_bit_for_bit(C, P, D):
    j, t = _pair(C, P, D)
    np.testing.assert_array_equal(tch.design_prototype(C, P),
                                  jch.design_prototype(C, P))
    np.testing.assert_array_equal(t.hp5.numpy(), np.asarray(j._hp5))
    np.testing.assert_array_equal(t.bperm5.numpy(), np.asarray(j._bperm5))
    assert t.fm_ref == float(j._fm_ref)
    np.testing.assert_array_equal(t.wr.numpy(), np.asarray(j._Wr))
    np.testing.assert_array_equal(t.wi.numpy(), np.asarray(j._Wi))
    np.testing.assert_array_equal(t.taps.numpy(),
                                  np.asarray(j._rhs)[:, 0, :])


@pytest.mark.parametrize("kind", ["make_input", "make_input_full"])
def test_synthetic_inputs_match_jax(kind):
    j, t = _pair(16, 4, 4)
    np.testing.assert_array_equal(getattr(t, kind)(256, seed=3),
                                  getattr(j, kind)(256, seed=3))


def test_make_input_full_on_a_torch_device_matches_numpy():
    _, t = _pair(16, 4, 4)
    a = t.make_input_full(256, seed=5)
    b = t.make_input_full(256, seed=5, device="cpu")
    assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
    assert np.abs(b.numpy() - a).max() <= 1e-4


def test_init_states():
    _, t = _pair(16, 4, 4)
    st = t.init_state()
    assert st["hist"].shape == (2, 16, 3) and st["prev"].shape == (2, 16)
    st4 = t.init_state_v4(torch.int8)
    assert st4["hist"].shape == (4, 32) and st4["hist"].dtype == torch.int8
    assert t.frames_for(16 * 100 + 5) == 100


@pytest.mark.parametrize("C,P,D", CONFIGS)
def test_step_matches_jax_step(C, P, D):
    j, t = _pair(C, P, D)
    iq = j.make_input_full(512, seed=1)
    ref, rst = j.step(j.init_state(), jnp.asarray(iq))
    got, gst = t.step(t.init_state(), torch.from_numpy(iq))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-4
    np.testing.assert_array_equal(gst["hist"].numpy(),
                                  np.asarray(rst["hist"]))
    assert np.abs(gst["prev"].numpy() - np.asarray(rst["prev"])).max() \
        <= 1e-4


@pytest.mark.parametrize("C,P,D", CONFIGS)
def test_step_kernel_matches_jax_step(C, P, D):
    j, t = _pair(C, P, D)
    iq = j.make_input_full(512, seed=2)
    ref, _ = j.step(j.init_state(), jnp.asarray(iq))
    got, st = t.step_kernel(t.init_state_v4(), torch.from_numpy(iq))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-4
    np.testing.assert_array_equal(st["hist"].numpy(),
                                  iq.reshape(-1, 2 * C)[-P:])


@pytest.mark.parametrize("mode", ["classic", "coherent"])
def test_step_kernel_streams(mode):
    _, t = _pair(16, 4, 4)
    iq = torch.from_numpy(t.make_input_full(1024, seed=4))
    whole, wst = t.step_kernel(t.init_state_v4(), iq, mode)
    a1, st = t.step_kernel(t.init_state_v4(), iq[:512], mode)
    a2, st = t.step_kernel(st, iq[512:], mode)
    assert (torch.cat([a1, a2]) - whole).abs().max() <= 1e-5
    assert torch.equal(st["hist"], wst["hist"])


def test_step_kernel_int8_ingest_matches_f32():
    """Mirror of the JAX test: CS8 rows convert in the load, and the
    scale-invariant discriminator needs no compensation."""
    _, t = _pair(8, 4, 4, sample_rate=8e5)
    iq = t.make_input_full(1024)
    q = torch.from_numpy(
        np.clip(np.round(iq * 127.0), -127, 127).astype(np.int8))
    a_f32, _ = t.step_kernel(t.init_state_v4(), q.float())
    a1, st = t.step_kernel(t.init_state_v4(torch.int8), q[:512])
    a2, _ = t.step_kernel(st, q[512:])
    assert torch.equal(torch.cat([a1, a2]), a_f32)


def test_step_kernel_rejects_short_input():
    _, t = _pair(8, 4, 4)
    with pytest.raises(ValueError):
        t.step_kernel(t.init_state_v4(), torch.zeros((2, 8, 2)))


def test_convert_tables_and_state_from_jax():
    j, t = _pair(16, 4, 4)
    tables = convert.channelizer_tables_from_arrays(
        {"hp5": np.asarray(j._hp5), "bperm5": np.asarray(j._bperm5),
         "fm_ref": np.asarray(j._fm_ref), "bp4": np.asarray(j._bp4),
         "rhs": np.asarray(j._rhs), "wr": np.asarray(j._Wr),
         "wi": np.asarray(j._Wi)}, device="cpu")
    for name in ("hp5", "bperm5", "bp4", "hp", "wr", "wi"):
        assert torch.equal(tables[name], getattr(t, name)), name
    assert tables["fm_ref"] == t.fm_ref
    iq = j.make_input_full(512, seed=6)
    _, jst = j.step_pallas_v4(j.init_state_v4(), jnp.asarray(iq[:256]),
                              interpret=True)
    state = convert.channelizer_state_from_arrays(
        {"hist": np.asarray(jst["hist"])}, device="cpu")
    fresh = tch.Channelizer(channels=16, taps_per_branch=4, audio_decim=4,
                            sample_rate=1.0, device="cpu")  # other fm_ref
    fresh.load_tables(tables)
    want, _ = t.step_kernel(state, torch.from_numpy(iq[256:]))
    got, _ = fresh.step_kernel(state, torch.from_numpy(iq[256:]))
    assert torch.equal(got, want)
    ref, _ = j.step_pallas_v4(jst, jnp.asarray(iq[256:]), interpret=True,
                              atan_mode="recip", decim_mode="sel")
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-4


def test_load_tables_rejects_wrong_shapes():
    _, t = _pair(16, 4, 4)
    tables = {name: getattr(t, name) for name in
              ("hp", "wr", "wi", "hp5", "bperm5", "bp4", "fm_ref")}
    with pytest.raises(ValueError, match="hp5"):
        t.load_tables({**tables, "hp5": torch.zeros(4, 16)})
    with pytest.raises(ValueError, match="bp4"):
        t.load_tables({k: v for k, v in tables.items() if k != "bp4"})
