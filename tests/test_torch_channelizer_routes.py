"""The channelizer's other kernel routes in the port against the JAX
package, on the CPU: K7 ``channelize_demod`` (``step_carry_kernel``, JAX
``step_pallas``, variants v1 and v2), K8 (``step_kernel(kernel="v4")``)
and K9 (``step_kernel(kernel="v6")``).  On CPU tensors the wrappers run
their plain versions; JAX runs its Pallas kernels in interpret mode.

Inputs: ``make_input_full`` (every channel occupied) or normal noise from
a numpy seed, never ``make_input``, whose empty channels demodulate to
atan-branch noise.

Tolerances: 1e-4 on audio and on K7's ``prev`` (the JAX tests' bar for
the exact path, ``tests/models/test_pallas_kernels.py``); the history
state exact; a stream split in two matches the whole to 1e-5; the tables
bit for bit.  K9 against JAX's interpret-mode v6 differs by JAX's
approximate reciprocal, which runs there as a bf16 divide before its
Newton step: 6e-6 to 1.8e-5 at these sizes, beside the 1e-4 bar; against
JAX's XLA ``step`` the port's K9 plain version lands within 1.1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyberether_tpu.models import channelizer as jch
from cyberether_tpu.ops import pallas_kernels as jk
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.models import channelizer as tch
from cyberether_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

CONFIGS = [(8, 4, 4), (16, 2, 2), (64, 8, 16)]
FRAMES = 1024               # two of JAX's 512-frame tiles
TOL = 1e-4
STREAM_TOL = 1e-5


def _pair(C, P, D, **kw):
    kw.setdefault("sample_rate", C * 2e6)
    j = jch.Channelizer(channels=C, taps_per_branch=P, audio_decim=D, **kw)
    t = tch.Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                        device="cpu", **kw)
    return j, t


def _err(got: torch.Tensor, ref) -> float:
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


def _jax_tables(j) -> dict:
    return {"hp5": np.asarray(j._hp5), "bperm5": np.asarray(j._bperm5),
            "fm_ref": np.asarray(j._fm_ref), "bp4": np.asarray(j._bp4),
            "rhs": np.asarray(j._rhs), "wr": np.asarray(j._Wr),
            "wi": np.asarray(j._Wi)}


# -- tables ------------------------------------------------------------------

@pytest.mark.parametrize("C,P,D", CONFIGS)
def test_tables_match_jax_bit_for_bit(C, P, D):
    j, t = _pair(C, P, D)
    rhs = np.asarray(j._rhs)[:, 0, :]                  # (C, P)
    np.testing.assert_array_equal(t.bp4.numpy(), np.asarray(j._bp4))
    np.testing.assert_array_equal(t.hp.numpy(), rhs.T)
    np.testing.assert_array_equal(t.taps.numpy(), rhs)
    np.testing.assert_array_equal(t.wr.numpy(), np.asarray(j._Wr))
    np.testing.assert_array_equal(t.wi.numpy(), np.asarray(j._Wi))


def test_fold_channelizer_matrices_matches_jax():
    rng = np.random.default_rng(0)
    hp = rng.standard_normal((3, 8)).astype(np.float32)
    wr, wi = rng.standard_normal((2, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(tk.fold_channelizer_matrices(hp, wr, wi),
                                  jk.fold_channelizer_matrices(hp, wr, wi))


def test_block_dft_matrix_is_the_complex_dft():
    rng = np.random.default_rng(1)
    C = 8
    k = np.arange(C)
    W = np.exp(-2j * np.pi * np.outer(k, k) / C)
    z = rng.standard_normal(C) + 1j * rng.standard_normal(C)
    b = tk.block_dft_matrix(torch.tensor(W.real), torch.tensor(W.imag))
    y = torch.tensor(np.concatenate([z.real, z.imag])) @ b
    np.testing.assert_allclose(y[:C] + 1j * y[C:], W @ z, atol=1e-12)


# -- K7: step_carry_kernel, JAX step_pallas ------------------------------------

@pytest.mark.parametrize("C,P,D", CONFIGS)
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_step_carry_kernel_matches_jax_step_pallas(variant, C, P, D):
    j, t = _pair(C, P, D)
    iq = j.make_input_full(FRAMES, seed=1)
    ref, rst = j.step_pallas(j.init_state(), jnp.asarray(iq),
                             interpret=True, variant=variant)
    got, gst = t.step_carry_kernel(t.init_state(), torch.from_numpy(iq),
                                   variant=variant)
    assert got.shape == (FRAMES // D, C) and got.dtype == torch.float32
    assert _err(got, ref) <= TOL
    assert _err(gst["prev"], rst["prev"]) <= TOL
    np.testing.assert_array_equal(gst["hist"].numpy(), np.asarray(rst["hist"]))


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_step_carry_kernel_streams(variant):
    """Two halves with the state carried: against the whole (1e-5) and
    against JAX's whole step (1e-4), the JAX test's split."""
    j, t = _pair(8, 4, 2)
    iq = j.make_input_full(FRAMES, seed=4)
    ref, _ = j.step_pallas(j.init_state(), jnp.asarray(iq), interpret=True,
                           variant=variant)
    whole, wst = t.step_carry_kernel(t.init_state(), torch.from_numpy(iq),
                                     variant=variant)
    a1, st = t.step_carry_kernel(t.init_state(),
                                 torch.from_numpy(iq[:FRAMES // 2]), variant)
    a2, st = t.step_carry_kernel(st, torch.from_numpy(iq[FRAMES // 2:]),
                                 variant)
    halves = torch.cat([a1, a2])
    assert float((halves - whole).abs().max()) <= STREAM_TOL
    assert _err(halves, ref) <= TOL
    assert torch.equal(st["hist"], wst["hist"])
    assert float((st["prev"] - wst["prev"]).abs().max()) <= STREAM_TOL


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_channelize_demod_plain_matches_jax_kernel(variant):
    """The kernel's contract alone: normal-noise ext over four of JAX's
    tiles, a non-zero ``prev``."""
    j, _ = _pair(8, 4, 4)
    P, C, M = 4, 8, FRAMES
    rng = np.random.default_rng(9)
    ext = rng.standard_normal((M + P - 1, 2 * C)).astype(np.float32)
    prev = rng.standard_normal((1, 2 * C)).astype(np.float32)
    hp = np.ascontiguousarray(np.asarray(j._rhs)[:, 0, :].T)
    wr, wi, g = np.array(j._Wr), np.array(j._Wi), float(j._fm_ref)
    ref, rlast = jk.channelize_demod(
        jnp.asarray(ext), jnp.asarray(hp), jnp.asarray(wr), jnp.asarray(wi),
        jnp.asarray(prev), g, tile_m=256, interpret=True, variant=variant)
    got, glast = tk.channelize_demod(
        torch.from_numpy(ext), torch.from_numpy(hp), torch.from_numpy(wr),
        torch.from_numpy(wi), torch.from_numpy(prev), g, variant)
    assert got.shape == (M, C) and glast.shape == (1, 2 * C)
    assert _err(got, ref) <= TOL
    assert _err(glast, rlast) <= TOL


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_step_carry_kernel_takes_one_tap(variant):
    """P = 1: no history rows.  JAX's kernel cannot tile an empty halo, so
    the port is held to JAX's XLA ``step`` here."""
    j, t = _pair(8, 1, 4)
    iq = j.make_input_full(256, seed=2)
    ref, rst = j.step(j.init_state(), jnp.asarray(iq))
    got, gst = t.step_carry_kernel(t.init_state(), torch.from_numpy(iq),
                                   variant)
    assert _err(got, ref) <= TOL
    assert _err(gst["prev"], rst["prev"]) <= TOL
    assert gst["hist"].shape == (2, 8, 0)


@pytest.mark.parametrize("route", ["v1", "v2", "v4", "v5", "v6"])
def test_model_routes_hand_the_kernel_contiguous_rows(route, monkeypatch):
    """The card's kernels read rows by pointer: every tensor a model
    route passes must be contiguous (the CPU plain versions would not
    notice)."""
    _, t = _pair(8, 4, 4)
    names = {"v1": "channelize_demod", "v2": "channelize_demod",
             "v4": "channelize_demod_decim_v4",
             "v5": "channelize_demod_decim",
             "v6": "channelize_demod_decim_v6"}
    wrapper, seen = getattr(tch, names[route]), []

    def checked(*args, **kw):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        seen.append(all(a.is_contiguous() for a in tensors))
        return wrapper(*args, **kw)

    monkeypatch.setattr(tch, names[route], checked)
    iq = torch.from_numpy(t.make_input_full(256, seed=12))
    if route in ("v1", "v2"):
        st = t.init_state()
        for _ in range(2):
            _, st = t.step_carry_kernel(st, iq, route)
    else:
        st = t.init_state_v4()
        for _ in range(2):
            _, st = t.step_kernel(st, iq, kernel=route)
    assert seen == [True, True]


def test_step_carry_kernel_rejects_ragged_frames():
    _, t = _pair(8, 4, 4)
    with pytest.raises(ValueError, match="multiple"):
        t.step_carry_kernel(t.init_state(), torch.zeros((250, 8, 2)))


# -- K8, K9: step_kernel(kernel="v4" | "v6"), JAX step_pallas_v4 -----------------

@pytest.mark.parametrize("C,P,D", CONFIGS)
@pytest.mark.parametrize("kernel", ["v4", "v6"])
def test_step_kernel_routes_match_jax(kernel, C, P, D):
    j, t = _pair(C, P, D)
    iq = j.make_input_full(FRAMES, seed=3)
    ref, rst = j.step_pallas_v4(j.init_state_v4(), jnp.asarray(iq),
                                interpret=True, kernel=kernel)
    got, gst = t.step_kernel(t.init_state_v4(), torch.from_numpy(iq),
                             kernel=kernel)
    assert got.shape == (FRAMES // D, C)
    assert _err(got, ref) <= TOL
    np.testing.assert_array_equal(gst["hist"].numpy(), np.asarray(rst["hist"]))
    # and the JAX XLA step, which the JAX tests hold every route to
    xla, _ = j.step(j.init_state(), jnp.asarray(iq))
    assert _err(got, xla) <= TOL


@pytest.mark.parametrize("kernel", ["v4", "v6"])
def test_step_kernel_routes_stream(kernel):
    j, t = _pair(8, 4, 2)
    iq = j.make_input_full(FRAMES, seed=24)
    ref, _ = j.step_pallas_v4(j.init_state_v4(), jnp.asarray(iq),
                              interpret=True, kernel=kernel)
    whole, wst = t.step_kernel(t.init_state_v4(), torch.from_numpy(iq),
                               kernel=kernel)
    a1, st = t.step_kernel(t.init_state_v4(),
                           torch.from_numpy(iq[:FRAMES // 2]), kernel=kernel)
    a2, st = t.step_kernel(st, torch.from_numpy(iq[FRAMES // 2:]),
                           kernel=kernel)
    halves = torch.cat([a1, a2])
    assert float((halves - whole).abs().max()) <= STREAM_TOL
    assert _err(halves, ref) <= TOL
    assert torch.equal(st["hist"], wst["hist"])


@pytest.mark.parametrize("kernel", ["v4", "v6"])
def test_step_kernel_routes_refuse_coherent(kernel):
    j, t = _pair(8, 4, 4)
    iq = j.make_input_full(512, seed=5)
    with pytest.raises(ValueError, match="coherent"):
        j.step_pallas_v4(j.init_state_v4(), jnp.asarray(iq), interpret=True,
                         kernel=kernel, demod_mode="coherent")
    with pytest.raises(ValueError, match="coherent"):
        t.step_kernel(t.init_state_v4(), torch.from_numpy(iq),
                      demod_mode="coherent", kernel=kernel)


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
@pytest.mark.parametrize("kernel", ["v4", "v6"])
def test_step_kernel_routes_refuse_integer_ingest(kernel, dtype):
    j, t = _pair(8, 4, 4)
    q = np.clip(np.round(j.make_input_full(512, seed=6) * 100), -127,
                127).astype(dtype)
    with pytest.raises(ValueError):
        j.step_pallas_v4(j.init_state_v4(jnp.dtype(dtype)), jnp.asarray(q),
                         interpret=True, kernel=kernel)
    tq = torch.from_numpy(q)
    with pytest.raises(TypeError, match="float32"):
        t.step_kernel(t.init_state_v4(tq.dtype), tq, kernel=kernel)


def test_step_kernel_rejects_unknown_kernel():
    _, t = _pair(8, 4, 4)
    with pytest.raises(ValueError, match="v5"):
        t.step_kernel(t.init_state_v4(), torch.zeros((256, 8, 2)),
                      kernel="v3")


# -- convert -------------------------------------------------------------------

@pytest.mark.parametrize("C,P,D", CONFIGS)
def test_convert_tables_round_trip(C, P, D):
    """The JAX model's tables, through convert, into a port model built
    for another rate (so another fm_ref): every route then gives the
    output of a port model built as the JAX one."""
    j, t = _pair(C, P, D)
    tables = convert.channelizer_tables_from_arrays(_jax_tables(j),
                                                    device="cpu")
    fresh = tch.Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                            sample_rate=1.0, device="cpu")
    fresh.load_tables(tables)
    iq = torch.from_numpy(j.make_input_full(512, seed=7))
    for kernel in ("v4", "v5", "v6"):
        want, _ = t.step_kernel(t.init_state_v4(), iq, kernel=kernel)
        got, _ = fresh.step_kernel(fresh.init_state_v4(), iq, kernel=kernel)
        assert torch.equal(got, want), kernel
    for variant in ("v1", "v2"):
        want, _ = t.step_carry_kernel(t.init_state(), iq, variant)
        got, _ = fresh.step_carry_kernel(fresh.init_state(), iq, variant)
        assert torch.equal(got, want), variant
    want, _ = t.step(t.init_state(), iq)
    got, _ = fresh.step(fresh.init_state(), iq)
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_convert_step_state_from_jax(variant):
    """JAX's state after a first half, through convert, continues the
    stream in the port as in JAX."""
    j, t = _pair(16, 4, 4)
    iq = j.make_input_full(FRAMES, seed=8)
    h = FRAMES // 2
    _, jst = j.step_pallas(j.init_state(), jnp.asarray(iq[:h]),
                           interpret=True, variant=variant)
    state = convert.channelizer_step_state_from_arrays(
        {"hist": np.asarray(jst["hist"]), "prev": np.asarray(jst["prev"])},
        device="cpu")
    ref, rst = j.step_pallas(jst, jnp.asarray(iq[h:]), interpret=True,
                             variant=variant)
    got, gst = t.step_carry_kernel(state, torch.from_numpy(iq[h:]), variant)
    assert _err(got, ref) <= TOL
    assert _err(gst["prev"], rst["prev"]) <= TOL
    np.testing.assert_array_equal(gst["hist"].numpy(), np.asarray(rst["hist"]))
    # the reference path takes the same state
    xla, _ = j.step(jst, jnp.asarray(iq[h:]))
    ref_path, _ = t.step(state, torch.from_numpy(iq[h:]))
    assert _err(ref_path, xla) <= TOL


@pytest.mark.parametrize("bad", ["hist_rank", "prev_shape"])
def test_convert_step_state_rejects_bad_shapes(bad):
    hist, prev = np.zeros((2, 8, 3)), np.zeros((2, 8))
    if bad == "hist_rank":
        hist = hist[0]
    else:
        prev = prev[:, :4]
    with pytest.raises(ValueError):
        convert.channelizer_step_state_from_arrays(
            {"hist": hist, "prev": prev}, device="cpu")


def test_convert_tables_rejects_a_bad_rhs():
    j, _ = _pair(8, 4, 4)
    arrays = {**_jax_tables(j), "rhs": np.asarray(j._rhs)[:, 0, :]}
    with pytest.raises(ValueError, match="rhs"):
        convert.channelizer_tables_from_arrays(arrays, device="cpu")


# -- the wrappers' checks --------------------------------------------------------

def _k7_args(C=8, P=4, M=256):
    j, t = _pair(C, P, 4)
    rng = np.random.default_rng(10)
    ext = torch.from_numpy(
        rng.standard_normal((M + P - 1, 2 * C)).astype(np.float32))
    return {"ext": ext, "hp": t.hp, "wr": t.wr, "wi": t.wi,
            "prev": torch.zeros((1, 2 * C)), "fm_ref": t.fm_ref}


@pytest.mark.parametrize("bad", ["variant", "ext_width", "ext_rows",
                                 "ext_dtype", "prev_shape", "wr_shape",
                                 "hp_empty", "tables_variant"])
def test_k7_wrapper_rejects_bad_arguments(bad):
    args, variant = _k7_args(), "v1"
    if bad == "variant":
        variant = "v3"
    elif bad == "ext_width":
        args["ext"] = args["ext"][:, :8]
    elif bad == "ext_rows":
        args["ext"] = args["ext"][:3]               # fewer than P rows
    elif bad == "ext_dtype":
        args["ext"] = args["ext"].double()
    elif bad == "prev_shape":
        args["prev"] = args["prev"].reshape(2, 8)
    elif bad == "wr_shape":
        args["wr"] = args["wr"][:4]
    elif bad == "tables_variant":                   # v2's folded stack
        args["tables"] = tk.k7_tables(args["hp"], args["wr"], args["wi"],
                                      "v2")
    else:
        args["hp"] = args["hp"][:0]
    with pytest.raises(ValueError):
        tk.channelize_demod(**args, variant=variant)


@pytest.mark.parametrize("bad", ["bp_shape", "hist_rows", "frames",
                                 "x_dtype"])
def test_k8_wrapper_rejects_bad_arguments(bad):
    _, t = _pair(8, 4, 4)
    x2, hist, bp, D = torch.zeros((256, 16)), torch.zeros((4, 16)), t.bp4, 4
    if bad == "bp_shape":
        bp = bp[:, :8]
    elif bad == "hist_rows":
        hist = hist[:3]
    elif bad == "frames":
        x2 = x2[:254]
    else:
        x2, hist = x2.to(torch.int8), hist.to(torch.int8)
    with pytest.raises((ValueError, TypeError)):
        tk.channelize_demod_decim_v4(x2, hist, bp, t.fm_ref, D)


@pytest.mark.parametrize("bad", ["bperm_shape", "hist_dtype", "x_dtype"])
def test_k9_wrapper_rejects_bad_arguments(bad):
    _, t = _pair(8, 4, 4)
    x2, hist, bperm = torch.zeros((256, 16)), torch.zeros((4, 16)), t.bperm5
    if bad == "bperm_shape":
        bperm = bperm[:, :8]
    elif bad == "hist_dtype":
        hist = hist.double()
    else:
        x2, hist = x2.to(torch.int16), hist.to(torch.int16)
    with pytest.raises((ValueError, TypeError)):
        tk.channelize_demod_decim_v6(x2, hist, t.hp5, bperm, t.fm_ref, 4)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_k7_model_tables_follow_load_tables(variant):
    """The model's K7 tables are the wrapper's own, rebuilt whenever
    load_tables installs new taps or DFT parts, and passing them changes
    nothing in the result."""
    _, t = _pair(8, 4, 4)
    hp2, mat = t.k7_tables[variant]
    want = tk.k7_tables(t.hp, t.wr, t.wi, variant)
    assert torch.equal(hp2, want[0]) and torch.equal(mat, want[1])
    args = _k7_args()
    got = tk.channelize_demod(**args, variant=variant,
                              tables=t.k7_tables[variant])
    ref = tk.channelize_demod(**args, variant=variant)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    tables = {k: getattr(t, k) for k in ("hp", "wr", "wi", "hp5", "bperm5",
                                         "bp4")}
    t.load_tables({**tables, "wr": 2.0 * t.wr, "fm_ref": t.fm_ref})
    again = tk.k7_tables(t.hp, 2.0 * tables["wr"], t.wi, variant)
    assert torch.equal(t.k7_tables[variant][1], again[1])
    assert not torch.equal(t.k7_tables[variant][1], mat)


@pytest.mark.parametrize("wrapper", ["channelize_demod",
                                     "channelize_demod_decim_v4",
                                     "channelize_demod_decim_v6"])
def test_wrappers_on_cpu_run_plain_without_counting(wrapper):
    _, t = _pair(8, 4, 4)
    iq = torch.from_numpy(t.make_input_full(256, seed=11))
    fn = getattr(tk, wrapper)
    before = fn.launches
    if wrapper == "channelize_demod":
        args = _k7_args()
        got = fn(**args, variant="v2")
        want = tk.channelize_demod_plain(**args, variant="v2")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        x2, hist = iq.reshape(256, 16), torch.zeros((4, 16))
        if wrapper.endswith("v4"):
            args = (x2, hist, t.bp4, t.fm_ref, 4)
            want = tk.channelize_demod_decim_v4_plain(*args)
        else:
            args = (x2, hist, t.hp5, t.bperm5, t.fm_ref, 4)
            want = tk.channelize_demod_decim_v6_plain(*args)
        assert torch.equal(fn(*args), want)
    assert fn.launches == before
