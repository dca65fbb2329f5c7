"""The stage ablations in the port against the JAX package's TPU ablation
bodies, on the CPU: K16 ``channelize_ablate`` (``chan_ablate.py``'s
``make_call`` with ``k_full`` .. ``k_fullrate``) and K17 ``wbfm_ablate``
(``wbfm_ablate.py``'s ``make_variant``), whose wrappers run their plain
versions on CPU tensors.

Both scripts measure at import, so the bodies are taken from the files
with ``ast`` and compiled alone, with the module constants they read
injected and a ``pl`` whose ``pallas_call`` runs in interpret mode.
``wbfm_ablate.py`` also cannot be imported today: it unpacks two band
matrices from ``_wbfm_bands``, which returns one, so the test rebuilds the
second (``B``) from the two-matrix formula the script was written for.

Inputs: ``make_input_full`` for the channelizer (every channel occupied:
an empty channel demodulates to atan-branch noise), normal noise from a
numpy seed for the WBFM front end.  Each port output is held to JAX's and
to a float64 truth of its contract, written here with numpy.

Tolerances: angles (the stages that take an atan2) 1e-4 absolute, the
JAX tests' bar for the exact path; every other output 1e-5 of its max|o|
(one float32 product and sum apart).  Exclusions, each named where it
applies:
- the TPU WBFM ablation at T = 129 drops the tap h[128] x[j - 129] at
  each multiple of 128 samples (its second band matrix has no row for
  it), so ``full`` and ``noatan`` are compared with JAX everywhere else,
  and with the float64 truth alone there;
- its ``shift`` variants take y[j - 1] by a roll that wraps within a
  tile, so they are compared with JAX everywhere but the first sample of
  each tile (``TILE`` x 128 samples);
- after a zero history the lag of sample 0 is y[-1] = 0, whose angle is
  the sign of a zero: angle outputs skip sample 0 there.
"""

import ast
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cyberether_tpu.models import channelizer as jch
from cyberether_tpu.ops import pallas_kernels as jk
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.models import channelizer as tch
from cyberether_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ABLATION = ROOT / "tools" / "ablation"
ANGLE_TOL = 1e-4
REL_TOL = 1e-5

# the interpret-mode stand-in of the scripts' ``pl``
_PL = types.SimpleNamespace(
    BlockSpec=pl.BlockSpec,
    pallas_call=functools.partial(pl.pallas_call, interpret=True))


def _bodies(file: str, names, **constants) -> dict:
    """The functions ``names`` of ``tools/ablation/<file>``, compiled alone
    from the file's source into one namespace holding ``constants``."""
    tree = ast.parse((ABLATION / file).read_text(), filename=file)
    nodes = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in nodes) == sorted(names)
    namespace = {"jnp": jnp, "jax": jax, "pl": _PL, "pltpu": pltpu,
                 "_atan2": jk._atan2, **constants}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), file, "exec"),
         namespace)
    return namespace


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _abs(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(ref, np.float64)).max())


# -- K16: chan_ablate ----------------------------------------------------------

C, P, D = 8, 4, 4
TM, FRAMES = 64, 256
GRID = FRAMES // TM
# the TPU body of each stage
CHAN_BODIES = {"full": "k_full", "no_fir": "k_nofir", "no_atan": "k_noatan",
               "no_demod": "k_nodemod", "matmul_only": "k_matmul_only",
               "reshape_mean": "k_reshape_mean", "full_rate": "k_fullrate"}
ANGLE_STAGES = ("full", "no_fir", "reshape_mean")


@pytest.fixture(scope="module")
def chan():
    """The JAX model, a port model with its tables carried through
    ``convert``, and a full-band stream of P + FRAMES frames."""
    j = jch.Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                        sample_rate=C * 2e6)
    t = tch.Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                        sample_rate=C * 2e6, device="cpu")
    t.load_tables(convert.channelizer_tables_from_arrays(
        {"hp5": np.asarray(j._hp5), "bperm5": np.asarray(j._bperm5),
         "fm_ref": np.asarray(j._fm_ref), "bp4": np.asarray(j._bp4),
         "rhs": np.asarray(j._rhs), "wr": np.asarray(j._Wr),
         "wi": np.asarray(j._Wi)}, device="cpu"))
    frames = j.make_input_full(P + FRAMES).reshape(P + FRAMES, 2 * C)
    bodies = _bodies("chan_ablate.py", ["make_call", *CHAN_BODIES.values()],
                     C=C, P=P, D=D, TM=TM, grid=GRID,
                     gain=float(j._fm_ref))
    return j, t, frames, bodies


def _chan_inputs(frames: np.ndarray, hist_kind: str):
    """(x2, hist): the last FRAMES frames, and zeros (the TPU script's
    first halo) or the P frames before them."""
    x2 = np.ascontiguousarray(frames[P:])
    hist = np.zeros((P, 2 * C), np.float32) if hist_kind == "zero" \
        else np.ascontiguousarray(frames[:P])
    return x2, hist


def _chan_jax(j, bodies, stage: str, x2, hist) -> np.ndarray:
    """The TPU body of ``stage`` through the script's ``make_call``, its
    halos and selector built as the script builds them, halo 0 ``hist``."""
    idx = np.arange(1, GRID)[:, None] * TM - P + np.arange(P)[None, :]
    halos = np.concatenate([hist[None], x2[idx]], 0)
    sel = np.kron(np.eye(TM // D, dtype=np.float32),
                  np.full((1, D), 1.0 / D, np.float32))
    out_rows = TM if stage == "full_rate" else TM // D
    call = bodies["make_call"](bodies[CHAN_BODIES[stage]], out_rows)
    return np.asarray(call(jnp.asarray(x2), jnp.asarray(halos),
                           j._hp5, j._bperm5, jnp.asarray(sel)))


def _chan_truth(x2, hist, hp, b, gain: float, stage: str) -> np.ndarray:
    """Each stage's contract in float64, with numpy's atan2."""
    x2, hist = x2.astype(np.float64), hist.astype(np.float64)
    hp, b = hp.astype(np.float64), b.astype(np.float64)
    g = float(np.float32(gain))
    M = x2.shape[0]

    def mean(v):
        return v.reshape(M // D, D, -1).mean(1)

    if stage == "matmul_only":
        return mean((x2 @ b)[:, :C])
    ext = np.concatenate([hist, x2])
    if stage == "no_fir":
        z = ext[:M + 1]
    else:
        z = sum(ext[p:p + M + 1] * hp[p] for p in range(P))
    y = z @ b
    if stage == "no_demod":
        return mean(y[1:, :C] * g)
    yc = y[:, :C] + 1j * y[:, C:]
    lag = np.conj(yc[:-1]) * yc[1:]
    if stage == "no_atan":
        return mean(lag.imag * g)
    angle = np.arctan2(lag.imag, lag.real) * g
    if stage == "full_rate":
        return np.concatenate([angle, lag.real], 1)
    return mean(angle)


def _chan_check(got, ref, stage: str) -> None:
    """The stage's bar: angles absolute, the rest of max|o|; full_rate's
    two halves each by its own."""
    if stage == "full_rate":
        assert _abs(got[:, :C], ref[:, :C]) <= ANGLE_TOL
        assert _rel(got[:, C:], ref[:, C:]) <= REL_TOL
    elif stage in ANGLE_STAGES:
        assert _abs(got, ref) <= ANGLE_TOL
    else:
        assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("hist_kind", ["zero", "stream"])
@pytest.mark.parametrize("stage", list(CHAN_BODIES))
def test_k16_matches_chan_ablate_body(chan, stage, hist_kind):
    j, t, frames, bodies = chan
    x2, hist = _chan_inputs(frames, hist_kind)
    ref = _chan_jax(j, bodies, stage, x2, hist)
    got = tk.channelize_ablate(torch.from_numpy(x2), torch.from_numpy(hist),
                               t.hp5, t.bperm5, t.fm_ref, D, stage).numpy()
    want = (FRAMES, 2 * C) if stage == "full_rate" else (FRAMES // D, C)
    assert got.shape == ref.shape == want
    _chan_check(got, ref, stage)
    truth = _chan_truth(x2, hist, t.hp5.numpy(), t.bperm5.numpy(), t.fm_ref,
                        stage)
    _chan_check(got, truth, stage)
    _chan_check(ref, truth, stage)


def test_k16_reshape_mean_is_full(chan):
    """The two TPU bodies compute one function: one instance runs both."""
    j, t, frames, bodies = chan
    x2, hist = _chan_inputs(frames, "stream")
    args = (torch.from_numpy(x2), torch.from_numpy(hist), t.hp5, t.bperm5,
            t.fm_ref, D)
    assert torch.equal(tk.channelize_ablate(*args, "reshape_mean"),
                       tk.channelize_ablate(*args, "full"))
    assert tk.channelize_ablate.launches == dict.fromkeys(
        tk.CHANNELIZE_ABLATE_INSTANCES, 0)


def test_k16_full_is_k9_function(chan):
    """``full`` is K1's function with the 5-term atan2 and a true
    division: K9's plain version, exactly."""
    _, t, frames, _ = chan
    x2, hist = (torch.from_numpy(a) for a in _chan_inputs(frames, "stream"))
    assert torch.equal(
        tk.channelize_ablate(x2, hist, t.hp5, t.bperm5, t.fm_ref, D),
        tk.channelize_demod_decim_v6_plain(x2, hist, t.hp5, t.bperm5,
                                           t.fm_ref, D))


def test_k16_no_fir_is_full_with_unit_taps(chan):
    _, t, frames, _ = chan
    x2, hist = (torch.from_numpy(a) for a in _chan_inputs(frames, "stream"))
    e0 = torch.zeros_like(t.hp5)
    e0[0] = 1.0
    assert torch.equal(
        tk.channelize_ablate(x2, hist, t.hp5, t.bperm5, t.fm_ref, D,
                             "no_fir"),
        tk.channelize_ablate(x2, hist, e0, t.bperm5, t.fm_ref, D))


def test_k16_rejects_what_it_does_not_take(chan):
    _, t, frames, _ = chan
    x2, hist = (torch.from_numpy(a) for a in _chan_inputs(frames, "zero"))
    with pytest.raises(ValueError, match="stage"):
        tk.channelize_ablate(x2, hist, t.hp5, t.bperm5, t.fm_ref, D, "k_full")
    with pytest.raises(TypeError, match="float32"):
        tk.channelize_ablate(x2.to(torch.int16), hist.to(torch.int16), t.hp5,
                             t.bperm5, t.fm_ref, D)
    with pytest.raises(ValueError, match="multiple of decim"):
        tk.channelize_ablate(x2[:250], hist, t.hp5, t.bperm5, t.fm_ref, D)
    # full_rate does not decimate: any M
    assert tk.channelize_ablate(x2[:250], hist, t.hp5, t.bperm5, t.fm_ref, D,
                                "full_rate").shape == (250, 2 * C)


# -- K17: wbfm_ablate ----------------------------------------------------------

N, TILE = 4096, 8
WBFM_VARIANTS = ("full", "noatan", "onlyfir", "shift", "shiftnoat")
WBFM_ANGLES = ("full", "shift")


def _taps(T: int) -> np.ndarray:
    """The script's Hamming-windowed sinc of T taps (T = 129 there)."""
    h = np.hamming(T) * np.sinc(0.4 * (np.arange(T) - (T - 1) / 2))
    return (h / h.sum()).astype(np.float32)


def _bands(taps: np.ndarray):
    """(A, B): the current and one-sample-delayed band matrices (256, 128)
    of the two-matrix ``_wbfm_bands`` the script unpacks.  Today's
    ``_wbfm_bands`` returns A alone, so the script's import fails; B is
    rebuilt here by that form's rule, B[127 + j - k, j] = h[k] where
    127 + j - k >= 0, which has no row for h[128] x[j - 129] at j = 0."""
    A = jk._wbfm_bands(taps.tobytes())
    B = np.zeros((256, 128), np.float32)
    for j in range(128):
        for k in range(taps.shape[0]):
            if 127 + j - k >= 0:
                B[127 + j - k, j] = taps[k]
    return A, B


def _wbfm_jax(variant: str, x, taps, hist) -> np.ndarray:
    A, B = _bands(taps)
    bodies = _bodies("wbfm_ablate.py", ["make_variant"], nf=N // 128,
                     TILE=TILE, K=taps.shape[0] - 1, hist=jnp.asarray(hist),
                     A=A, B=B)
    run = bodies["make_variant"](variant)
    return np.asarray(run(jnp.asarray(x))).reshape(-1)


def _wbfm_truth(x, taps, hist, variant: str) -> np.ndarray:
    """y = FIR over [0 | hist | x] in float64, y[-1] included."""
    K = taps.shape[0] - 1
    ext = np.concatenate([np.zeros((2, 1)), hist, x], 1).astype(np.float64)
    h = taps.astype(np.float64)
    y = np.stack([np.convolve(e, h, "valid") for e in ext])   # y[-1 ..]
    assert y.shape[1] == x.shape[1] + 1 and K == hist.shape[1]
    if variant == "onlyfir":
        return y[0, 1:] + y[1, 1:]
    yc = y[0] + 1j * y[1]
    lag = np.conj(yc[:-1]) * yc[1:]
    if variant in ("noatan", "shiftnoat"):
        return lag.real + lag.imag
    return np.arctan2(lag.imag, lag.real)


def _wbfm_check(got, ref, variant: str, keep) -> None:
    if variant in WBFM_ANGLES:
        assert _abs(got[keep], ref[keep]) <= ANGLE_TOL
    else:
        assert _rel(got[keep], ref[keep]) <= REL_TOL


@pytest.mark.parametrize("hist_kind", ["zero", "stream"])
@pytest.mark.parametrize("T", [9, 129])
@pytest.mark.parametrize("variant", WBFM_VARIANTS)
def test_k17_matches_wbfm_ablate_variant(variant, T, hist_kind):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, N)).astype(np.float32)
    taps = _taps(T)
    hist = np.zeros((2, T - 1), np.float32) if hist_kind == "zero" else \
        rng.standard_normal((2, T - 1)).astype(np.float32)
    ref = _wbfm_jax(variant, x, taps, hist)
    got = tk.wbfm_ablate(torch.from_numpy(x), torch.from_numpy(taps),
                         torch.from_numpy(hist), 1.0, variant).numpy()
    truth = _wbfm_truth(x, taps, hist, variant)
    assert got.shape == ref.shape == (N,)
    keep = np.ones(N, bool)
    if hist_kind == "zero" and variant in WBFM_ANGLES:
        keep[0] = False             # the lag of sample 0 is y[-1] = 0
    _wbfm_check(got, truth, variant, keep)          # the port: everywhere
    if variant.startswith("shift"):
        keep[::TILE * 128] = False  # the roll wraps within each tile
    elif T == 129 and variant != "onlyfir":
        keep[::128] = False         # JAX drops h[128] x[j - 129] there
    _wbfm_check(got, ref, variant, keep)


def test_k17_jax_misses_the_129th_tap_where_the_port_does_not():
    """The exclusion above is JAX's fault, not the port's: at T = 129 the
    TPU ablation's ``full`` is off the truth at multiples of 128, and
    exact elsewhere, while the port is exact at every sample."""
    rng = np.random.default_rng(129)
    x = rng.standard_normal((2, N)).astype(np.float32)
    taps, hist = _taps(129), rng.standard_normal((2, 128)).astype(np.float32)
    truth = _wbfm_truth(x, taps, hist, "noatan")
    ref = _wbfm_jax("noatan", x, taps, hist)
    scale = np.abs(truth).max()
    at = np.zeros(N, bool)
    at[::128] = True
    assert np.abs(ref[at] - truth[at]).max() / scale > 10 * REL_TOL
    assert np.abs(ref[~at] - truth[~at]).max() / scale <= REL_TOL
    got = tk.wbfm_ablate(torch.from_numpy(x), torch.from_numpy(taps),
                         torch.from_numpy(hist), 1.0, "noatan").numpy()
    assert np.abs(got - truth).max() / scale <= REL_TOL


def test_k17_full_is_k12_and_shift_runs_its_instance():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 1280)).astype(np.float32))
    taps = torch.from_numpy(_taps(129))
    hist = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    full = tk.wbfm_ablate(x, taps, hist, 0.5)
    assert torch.equal(full, tk.wbfm_fused(x, taps, hist, 0.5))
    assert torch.equal(tk.wbfm_ablate(x, taps, hist, 0.5, "shift"), full)
    assert torch.equal(tk.wbfm_ablate(x, taps, hist, 0.5, "shiftnoat"),
                       tk.wbfm_ablate(x, taps, hist, 0.5, "noatan"))
    assert tk.wbfm_ablate.launches == dict.fromkeys(
        tk.WBFM_ABLATE_INSTANCES, 0)


def test_k17_rejects_what_it_does_not_take():
    x = torch.zeros((2, 256))
    taps, hist = torch.ones(9), torch.zeros((2, 8))
    with pytest.raises(ValueError, match="stage"):
        tk.wbfm_ablate(x, taps, hist, 1.0, "roll")
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.wbfm_ablate(x[:, :200], taps, hist, 1.0)
    with pytest.raises(ValueError, match=r"\(2, n\)"):
        tk.wbfm_ablate(x.T.contiguous(), taps, hist, 1.0)
