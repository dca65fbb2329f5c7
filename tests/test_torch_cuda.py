"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA Hopper card and import nothing of JAX; here they
skip.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-4 on audio, demod and the spectrum (the exact tier), 1e-4
of max(1, max|y|) on K7's ylast (filterbank frames grow with C), 1e-5 of
max|X| on the FFT (the JAX tests' bar for ``fft_pallas``); a stream split
in two matches the whole to 1e-5; K10 and K11 1e-5 of their plain
versions (|X|^2: of each row's max), which round each step of the FFT as
the kernel does, and, apart from them, 1e-4 of a float64 truth of the
same epilogue and ablation flags (|X|^2: 1e-5 of each row's max); no
TF32 anywhere.
"""

import numpy as np
import pytest
import torch

from cyberether_tpu_torch.models.channelizer import Channelizer
from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
from cyberether_tpu_torch.models.wbfm import WbfmReceiver
from cyberether_tpu_torch.ops import kernels
from cyberether_tpu_torch.ops.windows import blackman

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("C,P,D", [(8, 4, 4), (16, 4, 4), (32, 8, 16),
                                   (64, 8, 16), (64, 16, 128)])
@pytest.mark.parametrize("mode", ["classic", "coherent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_kernel_matches_plain(cuda, C, P, D, mode, dtype):
    m = Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                    sample_rate=C * 2e6, device=cuda)
    M = 128 * 5 + 2 * D if 128 % D == 0 else 640      # a ragged last block
    x = m.make_input_full(M, seed=C, device=cuda).reshape(M, 2 * C)
    h = m.make_input_full(P, seed=C + 1, device=cuda).reshape(P, 2 * C)
    if dtype == torch.int8:
        s = 127 / float(x.abs().max())
        x = torch.round(x * s).clamp(-127, 127).to(dtype)
        h = torch.round(h * s).clamp(-127, 127).to(dtype)
    before = kernels.channelize_demod_decim.launches
    got = kernels.channelize_demod_decim(x, h, m.hp5, m.bperm5, m.fm_ref,
                                         D, mode)
    assert kernels.channelize_demod_decim.launches == before + 1
    ref = kernels.channelize_demod_decim_plain(x, h, m.hp5, m.bperm5,
                                               m.fm_ref, D, mode)
    torch.cuda.synchronize()
    assert got.shape == (M // D, C)
    assert float((got - ref).abs().max()) <= 1e-4


def test_kernel_rejects_what_it_does_not_take(cuda):
    m = Channelizer(channels=8, taps_per_branch=4, audio_decim=5,
                    sample_rate=16e6, device=cuda)
    x = torch.zeros((640, 16), device=cuda)
    with pytest.raises(ValueError, match="decim"):
        kernels.channelize_demod_decim(x, torch.zeros((4, 16), device=cuda),
                                       m.hp5, m.bperm5, m.fm_ref, 5)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.channelize_demod_decim(
            torch.zeros((32, 640), device=cuda).T, torch.zeros(
                (4, 32), device=cuda), torch.zeros((4, 32), device=cuda),
            torch.zeros((32, 32), device=cuda), 1.0, 4)


def test_flowgraph_on_the_card_matches_plain_chain(cuda):
    from cyberether_tpu_torch import Flowgraph

    C, P, D, M = 64, 8, 16, 4096
    m = Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                    device=cuda)
    fg = Flowgraph()
    fg.block_create("src", "dti", {"shape": [M, C], "dataType": "CF32"})
    fg.block_create("sq", "squelch", {"threshold": 0.25},
                    {"signal": "${graph.src.output.buffer}"})
    fg.block_create("chan", "channelizer", {},
                    {"buffer": "${graph.sq.output.signal}"},
                    provider="pallas")
    hist = torch.zeros((P, 2 * C), device=cuda)
    for seed in (1, 2):
        host = m.make_input_full(M, seed=seed)          # numpy: uploaded
        buf = (host[..., 0] + 1j * host[..., 1]).astype(np.complex64)
        fg.block_module("src").attach_buffer(buf)
        assert fg.compute()
        x = torch.from_numpy(host).to(cuda).reshape(M, 2 * C)
        ref = kernels.channelize_demod_decim_plain(x, hist, m.hp5,
                                                   m.bperm5, m.fm_ref, D)
        hist = x[M - P:]
        got = fg.scheduler.output_tensor("chan.audio")
        assert fg.scheduler.output_valid("chan.audio")
        assert float((got - ref).abs().max()) <= 1e-4
    fg.stop()


CHAN_CONFIGS = [(8, 4, 4), (16, 4, 4), (32, 8, 16), (64, 8, 16),
                (64, 16, 128)]


def _chan_rows(cuda, C, P, D, M, seed):
    """A model, M interleaved frames (M, 2C) of a full band, and a
    non-zero history of P rows (the frames of another input)."""
    m = Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                    sample_rate=C * 2e6, device=cuda)
    x = m.make_input_full(M, seed=seed, device=cuda).reshape(M, 2 * C)
    h = m.make_input_full(P, seed=seed + 1, device=cuda).reshape(P, 2 * C)
    return m, x, h


def _decim_route(m, kernel, x, h):
    """(wrapper, plain version, arguments) of K8 ("v4") or K9 ("v6")."""
    if kernel == "v4":
        return (kernels.channelize_demod_decim_v4,
                kernels.channelize_demod_decim_v4_plain,
                (x, h, m.bp4, m.fm_ref, m.audio_decim))
    return (kernels.channelize_demod_decim_v6,
            kernels.channelize_demod_decim_v6_plain,
            (x, h, m.hp5, m.bperm5, m.fm_ref, m.audio_decim))


@pytest.mark.parametrize("C,P,D", CHAN_CONFIGS)
@pytest.mark.parametrize("kernel", ["v4", "v6"])
def test_decim_routes_match_plain(cuda, kernel, C, P, D):
    M = 128 * 5 + 2 * D                                # a ragged last block
    m, x, h = _chan_rows(cuda, C, P, D, M, seed=C)
    fn, plain, args = _decim_route(m, kernel, x, h)
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    ref = plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (M // D, C)
    assert float((got - ref).abs().max()) <= 1e-4


def _k1_case(cuda, C, P, D, M, dtype, seed):
    """``_chan_rows``'s model and rows, quantized to ``dtype``'s full range
    for integer ingest."""
    m, x, h = _chan_rows(cuda, C, P, D, M, seed)
    if dtype != torch.float32:
        full = torch.iinfo(dtype).max
        s = full / float(x.abs().max())
        x = torch.round(x * s).clamp(-full, full).to(dtype)
        h = torch.round(h * s).clamp(-full, full).to(dtype)
    return m, x, h


def _tc_frames(D, chunks):
    """Frames for ``chunks`` 128-frame chunks and a ragged last one where D
    allows: 5 chunks give one chunk a block, 300 several a block of the
    persistent grid."""
    return 128 * chunks + (2 * D if 2 * D < 128 else 0)


@pytest.mark.parametrize("chunks", [5, 300])
@pytest.mark.parametrize("C,P,D", CHAN_CONFIGS)
@pytest.mark.parametrize("mode", ["classic", "coherent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.int16])
def test_k1_tensor_template_matches_plain(cuda, C, P, D, mode, dtype,
                                          chunks):
    assert kernels.k1_instance(C, dtype).startswith("channelize_tc_kernel")
    M = _tc_frames(D, chunks)
    m, x, h = _k1_case(cuda, C, P, D, M, dtype, seed=C + chunks)
    before = kernels.channelize_demod_decim.launches
    got = kernels.channelize_demod_decim(x, h, m.hp5, m.bperm5, m.fm_ref, D,
                                         mode)
    assert kernels.channelize_demod_decim.launches == before + 1
    ref = kernels.channelize_demod_decim_plain(x, h, m.hp5, m.bperm5,
                                               m.fm_ref, D, mode)
    torch.cuda.synchronize()
    assert got.shape == (M // D, C) and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("chunks", [5, 300])
@pytest.mark.parametrize("C,P,D", CHAN_CONFIGS)
def test_k9_tensor_template_matches_plain(cuda, C, P, D, chunks):
    assert kernels.k1_instance(C, atan="poly5rcp").startswith(
        "channelize_tc_kernel")
    M = _tc_frames(D, chunks)
    m, x, h = _chan_rows(cuda, C, P, D, M, seed=C + chunks)
    fn, plain, args = _decim_route(m, "v6", x, h)
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    ref = plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (M // D, C) and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("split", [1040, 128 * 150 + 48])
@pytest.mark.parametrize("kernel", ["v5", "v6"])
def test_k1_streams_in_two_at_a_frame_off_the_tiles(cuda, kernel, split):
    """A split at a frame that is no multiple of the 64-row tiles, on the
    persistent grid: every y frame is summed by the same arithmetic
    wherever it is computed."""
    assert split % 64
    m, x, h = _chan_rows(cuda, 64, 8, 16, 128 * 300, seed=11)

    def run(xs, hs):
        if kernel == "v5":
            return kernels.channelize_demod_decim(xs, hs, m.hp5, m.bperm5,
                                                  m.fm_ref, 16)
        fn, _, args = _decim_route(m, kernel, xs, hs)
        return fn(*args)

    whole = run(x, h)
    a1 = run(x[:split], h)
    a2 = run(x[split:], x[split - 8:split].contiguous())
    assert float((torch.cat([a1, a2]) - whole).abs().max()) <= 1e-5


@pytest.mark.parametrize("kernel", ["v4", "v6"])
def test_decim_routes_stream_in_two(cuda, kernel):
    m, x, h = _chan_rows(cuda, 64, 8, 16, 4096, seed=3)
    fn, _, args = _decim_route(m, kernel, x, h)
    whole = fn(*args)
    a1 = fn(*_decim_route(m, kernel, x[:1040], h)[2])
    a2 = fn(*_decim_route(m, kernel, x[1040:], x[1032:1040])[2])
    assert float((torch.cat([a1, a2]) - whole).abs().max()) <= 1e-5


def _k7_case(cuda, C, P, M, seed):
    """A model, ext (M + P - 1, 2C) re|im-halves rows of a full band, and
    a non-zero prev (1, 2C)."""
    m = Channelizer(channels=C, taps_per_branch=P, audio_decim=1,
                    sample_rate=C * 2e6, device=cuda)
    rows = m.make_input_full(M + P, seed=seed, device=cuda)
    ext = rows[1:].permute(0, 2, 1).reshape(M + P - 1, 2 * C).contiguous()
    prev = rows[:1].permute(0, 2, 1).reshape(1, 2 * C).contiguous()
    return m, ext, prev


def _ylast_err(got, ref) -> float:
    """|ylast - ref| over max(1, max|ref|): y frames grow with C."""
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("C,P", [(8, 1), (8, 4), (16, 4), (32, 8), (64, 8),
                                 (64, 16)])
@pytest.mark.parametrize("M", [128, 700])
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_channelize_demod_matches_plain(cuda, variant, C, P, M):
    m, ext, prev = _k7_case(cuda, C, P, M, seed=C + P)
    args = (ext, m.hp, m.wr, m.wi, prev, m.fm_ref, variant)
    before = kernels.channelize_demod.launches
    got, glast = kernels.channelize_demod(*args)
    assert kernels.channelize_demod.launches == before + 1
    ref, rlast = kernels.channelize_demod_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (M, C) and glast.shape == (1, 2 * C)
    assert float((got - ref).abs().max()) <= 1e-4
    assert _ylast_err(glast, rlast) <= 1e-4


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_channelize_demod_carries_prev_across_calls(cuda, variant):
    """Two calls, the second seeded with the first's ylast, against one
    call over both: frame 0 of the second lags on a frame from the
    first.  The halves take the model's tables, as its steps do."""
    m, ext, prev = _k7_case(cuda, 64, 8, 1500, seed=5)
    K = kernels.channelize_demod
    rest, tables = (m.hp, m.wr, m.wi), m.k7_tables[variant]
    whole, wlast = K(ext, *rest, prev, m.fm_ref, variant)
    h = 700                                   # not a multiple of 128
    a1, l1 = K(ext[:h + 7].contiguous(), *rest, prev, m.fm_ref, variant,
               tables)
    a2, l2 = K(ext[h:].contiguous(), *rest, l1, m.fm_ref, variant, tables)
    assert float((torch.cat([a1, a2]) - whole).abs().max()) <= 1e-5
    assert _ylast_err(l2, wlast) <= 1e-5


def test_channelizer_routes_reject_what_they_do_not_take(cuda):
    m, x, h = _chan_rows(cuda, 8, 4, 4, 640, seed=1)
    with pytest.raises(ValueError, match="decim"):
        kernels.channelize_demod_decim_v4(x, h, m.bp4, m.fm_ref, 5)
    with pytest.raises(ValueError, match="decim"):
        kernels.channelize_demod_decim_v6(x, h, m.hp5, m.bperm5, m.fm_ref, 5)
    with pytest.raises(TypeError, match="float32"):
        kernels.channelize_demod_decim_v4(x.to(torch.int8), h.to(torch.int8),
                                          m.bp4, m.fm_ref, 4)
    odd = Channelizer(channels=12, taps_per_branch=4, audio_decim=4,
                      device=cuda)
    ext = torch.zeros((259, 24), device=cuda)
    prev = torch.zeros((1, 24), device=cuda)
    with pytest.raises(ValueError, match="C in"):
        kernels.channelize_demod(ext, odd.hp, odd.wr, odd.wi, prev, 1.0)
    long = Channelizer(channels=8, taps_per_branch=17, audio_decim=4,
                       device=cuda)
    ext = torch.zeros((272, 16), device=cuda)
    with pytest.raises(ValueError, match="P <="):
        kernels.channelize_demod(ext, long.hp, long.wr, long.wi,
                                 torch.zeros((1, 16), device=cuda), 1.0, "v2")
    with pytest.raises(ValueError, match="contiguous"):
        kernels.channelize_demod(
            torch.zeros((16, 259), device=cuda).T, m.hp, m.wr, m.wi,
            torch.zeros((1, 16), device=cuda), 1.0)


@pytest.mark.parametrize("route", ["v4", "v6", "v1", "v2"])
def test_channelizer_routes_launch_once_a_step(cuda, route):
    """Two streaming steps of a model route on the card, each launching
    its kernel once, against the same model on the CPU (its plain
    versions)."""
    C, P, D, M = 64, 8, 16, 4096
    card = Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                       device=cuda)
    host = Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                       device="cpu")
    carry = route in ("v1", "v2")
    fn = {"v1": kernels.channelize_demod, "v2": kernels.channelize_demod,
          "v4": kernels.channelize_demod_decim_v4,
          "v6": kernels.channelize_demod_decim_v6}[route]
    st_card = card.init_state() if carry else card.init_state_v4()
    st_host = host.init_state() if carry else host.init_state_v4()
    for seed in (1, 2):
        iq = host.make_input_full(M, seed=seed)
        before = fn.launches
        if carry:
            got, st_card = card.step_carry_kernel(
                st_card, torch.from_numpy(iq).to(cuda), route)
            ref, st_host = host.step_carry_kernel(
                st_host, torch.from_numpy(iq), route)
        else:
            got, st_card = card.step_kernel(
                st_card, torch.from_numpy(iq).to(cuda), kernel=route)
            ref, st_host = host.step_kernel(
                st_host, torch.from_numpy(iq), kernel=route)
        assert fn.launches == before + 1
        assert float((got.cpu() - ref).abs().max()) <= 1e-4
        assert torch.equal(st_card["hist"].cpu(), st_host["hist"])


def _wbfm(cuda, D=40, seed=0, n=128 * 37):
    """A receiver, n samples of its input (n / 128 odd: a ragged last
    block) and a non-zero history (the tail of another input)."""
    rx = WbfmReceiver(audio_decim=D, device=cuda)
    iq = rx.make_input(n, seed=seed, device=cuda)
    hist = rx.make_input(256, seed=seed + 1, device=cuda)[-128:].T \
        .contiguous()
    return rx, iq, hist


@pytest.mark.parametrize("D", [0, 1, 6, 40, 2048])
@pytest.mark.parametrize("n", [128 * 37, 128 * 400])
def test_wbfm_v2_matches_plain(cuda, D, n):
    rx, iq, hist = _wbfm(cuda, n=n)
    before = kernels.wbfm_fused_v2.launches
    got = kernels.wbfm_fused_v2(iq, rx._taps, hist, rx._ref, D)
    assert kernels.wbfm_fused_v2.launches == before + 1
    ref = kernels.wbfm_fused_v2_plain(iq, rx._taps, hist, rx._ref, D)
    torch.cuda.synchronize()
    assert got.shape == ((n // D,) if D else (n,))
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("n", [128 * 37, 128 * 400])
def test_wbfm_v1_matches_plain(cuda, n):
    rx, iq, hist = _wbfm(cuda, n=n)
    x = iq.T.contiguous()
    before = kernels.wbfm_fused.launches
    got = kernels.wbfm_fused(x, rx._taps, hist, rx._ref)
    assert kernels.wbfm_fused.launches == before + 1
    ref = kernels.wbfm_fused_plain(x, rx._taps, hist, rx._ref)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("T", [2, 33, 129])
def test_wbfm_taps_and_zero_history(cuda, T):
    """Other tap counts (a ragged last group of 8 taps), from a zero
    history: the first lag products match the plain version's bit for
    bit, so the warm-up angles agree too."""
    rx = WbfmReceiver(taps=T, device=cuda)
    iq = rx.make_input(128 * 37, seed=T, device=cuda)
    hist = torch.zeros((2, T - 1), device=cuda)
    for D in (0, 40):
        got = kernels.wbfm_fused_v2(iq, rx._taps, hist, rx._ref, D)
        ref = kernels.wbfm_fused_v2_plain(iq, rx._taps, hist, rx._ref, D)
        assert float((got - ref).abs().max()) <= 1e-4
    got = kernels.wbfm_fused(iq.T.contiguous(), rx._taps, hist, rx._ref)
    ref = kernels.wbfm_fused_plain(iq.T, rx._taps, hist, rx._ref)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("D", [0, 40])
def test_wbfm_streams_in_two(cuda, D):
    rx, iq, hist = _wbfm(cuda, n=128 * 400)
    h = 128 * 200
    whole = kernels.wbfm_fused_v2(iq, rx._taps, hist, rx._ref, D)
    a1 = kernels.wbfm_fused_v2(iq[:h], rx._taps, hist, rx._ref, D)
    a2 = kernels.wbfm_fused_v2(iq[h:], rx._taps, iq[h - 128:h].T.contiguous(),
                               rx._ref, D)
    assert float((torch.cat([a1, a2]) - whole).abs().max()) <= 1e-5


def test_wbfm_kernel_rejects_what_it_does_not_take(cuda):
    rx, iq, hist = _wbfm(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.wbfm_fused(iq.T, rx._taps, hist, rx._ref)
    with pytest.raises(ValueError, match="coherent_decim"):
        kernels.wbfm_fused_v2(iq, rx._taps, hist, rx._ref, 250)
    flat = torch.empty(iq.numel() + 1, device=cuda)
    odd = flat[1:].view(-1, 2)               # contiguous, 4 bytes off
    odd.copy_(iq)
    with pytest.raises(ValueError, match="aligned"):
        kernels.wbfm_fused_v2(odd, rx._taps, hist, rx._ref)
    before = kernels.wbfm_fused_v2.launches
    short = kernels.wbfm_fused_v2(iq[:128], rx._taps, hist, rx._ref, 2048)
    assert short.shape == (0,) and kernels.wbfm_fused_v2.launches == before


def test_wbfm_flowgraph_on_the_card_matches_plain_chain(cuda):
    from cyberether_tpu_torch import Flowgraph

    n, D = 128 * 400, 40
    rx = WbfmReceiver(device=cuda)
    fg = Flowgraph()
    fg.block_create("src", "dti", {"shape": [n], "dataType": "CF32"})
    fg.block_create("rx", "wbfm", {},
                    {"buffer": "${graph.src.output.buffer}"},
                    provider="pallas")
    hist = torch.zeros((2, 128), device=cuda)
    for seed in (1, 2):
        host = rx.make_input(n, seed=seed)              # numpy: uploaded
        fg.block_module("src").attach_buffer(
            (host[:, 0] + 1j * host[:, 1]).astype(np.complex64))
        assert fg.compute()
        x = torch.from_numpy(host).to(cuda)
        ref = kernels.wbfm_fused_v2_plain(x, rx._taps, hist, rx._ref) \
            .reshape(-1, D).mean(1)
        hist = x[n - 128:].T.contiguous()
        got = fg.scheduler.output_tensor("rx.audio")
        assert fg.scheduler.output_valid("rx.audio")
        assert float((got - ref).abs().max()) <= 1e-4
    fg.stop()


def _spectrum(cuda, n, B, seed=0):
    sp = SpectrumPipeline(fft_size=n, batches=B, device=cuda)
    return sp, sp.make_input(seed=seed, device=cuda)


def _spectrum_pair(sp, iq):
    before = kernels.spectrum_fused_ct5.launches
    got = kernels.spectrum_fused_ct5(iq, sp._win, sp._coeff, sp._scale,
                                     sp._offset)
    assert kernels.spectrum_fused_ct5.launches == before + 1
    ref = kernels.spectrum_fused_ct5_plain(iq, sp._win, sp._coeff,
                                           sp._scale, sp._offset)
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096])
def test_spectrum_matches_plain(cuda, n):
    """13 rows: not a multiple of the 8, 4 or 2 rows a block holds for
    n < 1024; row 5 is all zeros."""
    sp, iq = _spectrum(cuda, n, 13, seed=n)
    iq[5] = 0.0
    got, ref = _spectrum_pair(sp, iq)
    assert got.shape == (13, n)
    assert float((got - ref).abs().max()) <= 1e-4
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    assert bool((got[5] == 0.0).all())


@pytest.mark.parametrize("B", [1, 3, 9])
def test_spectrum_ragged_batches_and_zero_rows(cuda, B):
    sp, iq = _spectrum(cuda, 128, B, seed=B)
    iq[-1] = 0.0
    got, ref = _spectrum_pair(sp, iq)
    assert float((got - ref).abs().max()) <= 1e-4
    assert bool((got[-1] == 0.0).all())


def test_spectrum_kernel_rejects_what_it_does_not_take(cuda):
    sp, iq = _spectrum(cuda, 256, 4)
    flat = torch.empty(iq.numel() + 1, device=cuda)
    odd = flat[1:].view(4, 256, 2)           # contiguous, 4 bytes off
    odd.copy_(iq)
    with pytest.raises(ValueError, match="aligned"):
        kernels.spectrum_fused_ct5(odd, sp._win, sp._coeff, sp._scale,
                                   sp._offset)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.spectrum_fused_ct5(iq.transpose(0, 1).contiguous()
                                   .transpose(0, 1), sp._win, sp._coeff,
                                   sp._scale, sp._offset)
    with pytest.raises(ValueError, match="n=384"):
        kernels.spectrum_fused_ct5(torch.zeros((2, 384, 2), device=cuda),
                                   torch.zeros(384, device=cuda), 0.0, 1.0,
                                   0.0)


def test_spectrum_flowgraph_on_the_card_matches_plain_chain(cuda):
    from cyberether_tpu_torch import Flowgraph

    B, n = 64, 2048
    sp = SpectrumPipeline(fft_size=n, batches=B, device=cuda)
    fg = Flowgraph()
    fg.block_create("src", "dti", {"shape": [B, n], "dataType": "CF32"})
    fg.block_create("spec", "spectrum", {},
                    {"buffer": "${graph.src.output.buffer}"},
                    provider="pallas")
    before = kernels.spectrum_fused_ct5.launches
    for seed in (1, 2):
        host = sp.make_input(seed=seed)                 # numpy: uploaded
        fg.block_module("src").attach_buffer(
            (host[..., 0] + 1j * host[..., 1]).astype(np.complex64))
        assert fg.compute()
        ref = kernels.spectrum_fused_ct5_plain(
            torch.from_numpy(host).to(cuda), sp._win, sp._coeff, sp._scale,
            sp._offset)
        got = fg.scheduler.output_tensor("spec.spectrum")
        assert fg.scheduler.output_valid("spec.spectrum")
        assert float((got - ref).abs().max()) <= 1e-4
    assert kernels.spectrum_fused_ct5.launches == before + 2
    fg.stop()


def _zero_row_spectrum(cuda, n, B, seed):
    """A spectrum pipeline and its input on the card, the middle row all
    zeros."""
    sp, iq = _spectrum(cuda, n, B, seed=seed)
    iq[B // 2] = 0.0
    return sp, iq


def _held_to_plain(kernel, plain, sp, iq):
    """Launch ``kernel`` once and hold it to ``plain``: 1e-4, the same
    argmax in every row (for n <= 3, but for bins the float64 truth ties:
    at n = 3 the window leaves one sample, and every bin holds its
    magnitude), exactly 0 on the zero row; then 1e-3 of a float64 truth
    (complex128 ``torch.fft.fft``)."""
    before = kernel.launches
    args = (sp._win, sp._coeff, sp._scale, sp._offset)
    got = kernel(iq, *args)
    assert kernel.launches == before + 1
    ref = plain(iq, *args)
    x = torch.view_as_complex(iq.double()) * sp._win.double()
    db = 10.0 * torch.log10(torch.fft.fft(x, dim=-1).abs() ** 2) + sp._coeff
    truth = 0.5 + 0.5 * torch.tanh(4.0 * (db * sp._scale + sp._offset - 0.5))
    torch.cuda.synchronize()
    B, n = iq.shape[:2]
    assert got.shape == (B, n) and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-4
    a, b = got.argmax(-1, keepdim=True), ref.argmax(-1, keepdim=True)
    if n > 3:
        assert torch.equal(a, b)
    else:
        tied = (truth.gather(-1, a) - truth.gather(-1, b)).abs() <= 1e-12
        assert bool(((a == b) | tied).all())
    assert bool((got[B // 2] == 0.0).all())
    assert float((got.double() - truth).abs().max()) <= 1e-3


K6_FFT_SIZES = [1, 2, 3, 5, 7, 64, 100, 127, 128, 384, 1536, 2048, 4224,
                8192, 16384, 131, 1021, 2042, 2036]


@pytest.mark.parametrize("n", K6_FFT_SIZES)
@pytest.mark.parametrize("B", [1, 13, 129])
def test_spectrum_dft_matches_plain(cuda, n, B):
    """K6's FFT route at ragged B (not a multiple of the rows a block
    holds) and n: register radices, direct p-point stages (127, 4224 =
    128 x 3 x 11), the runtime plan, every templated power of two, and
    the large-prime pass (131, 1021, 2042 = 2 x 1021, 2036 = 4 x 509)."""
    sp, iq = _zero_row_spectrum(cuda, n, B, seed=n + B)
    assert kernels.k6_route(n) == "fft"
    before = dict(kernels.spectrum_fused.routes)
    _held_to_plain(kernels.spectrum_fused, kernels.spectrum_fused_plain,
                   sp, iq)
    assert kernels.spectrum_fused.routes == {**before,
                                             "fft": before["fft"] + 1}


@pytest.mark.parametrize("B", [1, 13])
def test_spectrum_dft_direct_route_matches_plain(cuda, B):
    """n = 16512 = 128 x 129, past the FFT route's 16384 points, which the
    direct product took before the split route: now the split route (two
    passes of the core, 128-point columns and 129-point rows on the
    runtime plan), held to the same bars and to the model of its passes
    (1e-4)."""
    _held_on_split_route(cuda, 16512, B)


def _held_on_split_route(cuda, n, B):
    sp, iq = _zero_row_spectrum(cuda, n, B, seed=n + B)
    assert kernels.k6_route(n) == "split"
    before = dict(kernels.spectrum_fused.routes)
    _held_to_plain(kernels.spectrum_fused, kernels.spectrum_fused_plain,
                   sp, iq)
    assert kernels.spectrum_fused.routes == {**before,
                                             "split": before["split"] + 1}
    args = (sp._win, sp._coeff, sp._scale, sp._offset)
    got = kernels.spectrum_fused(iq, *args)
    ref = kernels.spectrum_split_plain(iq, *args)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("n", [32768, 65536, 16768, 32896, 65152, 130688,
                               33536, 64256])
@pytest.mark.parametrize("B", [1, 13])
def test_spectrum_dft_split_route_matches_plain(cuda, n, B):
    """n = 128 x 256 and 256 x 256: both passes on the pow2 instances;
    128 p for p = 131, 257, 509, 1021: 128-point columns and p-point
    rows on the large-prime pass; 131 x 256 and 251 x 256: the prime
    first, so pass A's columns go through the large-prime pass."""
    if n in (33536, 64256):
        assert kernels._large_prime(kernels.k6_split(n)[0])
    _held_on_split_route(cuda, n, B)


def _primes(lo, hi):
    return [p for p in range(lo, hi + 1)
            if all(p % d for d in range(2, int(p ** 0.5) + 1))]


K6_RUNTIME_SIZES = sorted(set(range(1, 128)) | {
    p << a for p in (11, 13, 31, 61, 127) for a in range(1, 8)
    if 128 < p << a <= 16384} | {4224, 12288, 14976, 15488, 16256} |
    set(_primes(131, 1021)) | {262, 514, 1018, 2042, 524, 1028, 2036, 655,
                               917, 1048, 1441})


@pytest.mark.parametrize("n", K6_RUNTIME_SIZES)
def test_spectrum_dft_runtime_plan_at_every_n(cuda, n):
    """The runtime-plan instance on 37 rows at every n below 128, at
    n = p 2^a for primes p past 7 (a direct
    p-point pass after the register passes), and at the largest admitted
    n of each block (14976 = 128 x 9 x 13 and 15488 = 128 x 11 x 11 fill
    512 threads' items); and the large-prime pass (256 threads of 12
    values) at every prime from 131 to 1021, at 2 and 4 times the four
    that the spectrum sizes past 16384 reach at 8.39 Msamp (257, 509,
    1021, 131; where a block holds them), after register radices (655 =
    5 x 131, 917 = 7 x 131, 1048 = 8 x 131) and after a small prime (1441
    = 11 x 131)."""
    sp, iq = _zero_row_spectrum(cuda, n, 37, seed=n)
    assert kernels.k6_route(n) == "fft"
    _held_to_plain(kernels.spectrum_fused, kernels.spectrum_fused_plain,
                   sp, iq)


def _held_on_chirp_route(cuda, n, B, product=True):
    """K6 on its chirp route, held as ``_held_to_plain`` holds it and to
    the model of its steps (``spectrum_chirp_plain``, 1e-4, the same
    argmax bin in every row), with ``routes["chirp"]`` counted.  Without
    ``product`` (rows past a million points, where the float64 product of
    K6's plain version would take minutes a row) ``_held_to_plain`` holds
    it to the model of its steps alone, the float64 truth included."""
    sp, iq = _zero_row_spectrum(cuda, n, B, seed=n + B)
    assert kernels.k6_route(n) == "chirp"
    before = dict(kernels.spectrum_fused.routes)
    _held_to_plain(kernels.spectrum_fused, kernels.spectrum_fused_plain
                   if product else kernels.spectrum_chirp_plain, sp, iq)
    assert kernels.spectrum_fused.routes == {**before,
                                             "chirp": before["chirp"] + 1}
    args = (sp._win, sp._coeff, sp._scale, sp._offset)
    got = kernels.spectrum_fused(iq, *args)
    ref = kernels.spectrum_chirp_plain(iq, *args)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("n", [1031, 16381, 16500])
@pytest.mark.parametrize("B", [1, 13, 129])
def test_spectrum_dft_direct_route_at_ragged_n(cuda, n, B):
    """Ragged n on K6's routes past the FFT route: the chirp route at a
    prime past 1021 (1031: M = 2560, one launch, a block a row) and at
    the largest prime below 16384 (16381: M = 32768 = 128 x 256, three
    launches), neither of which splits; the split route at 16500 = 125 x
    132 (both factors on the runtime plan, columns and rows of a block
    not dividing B n_i)."""
    if n != 16500:
        _held_on_chirp_route(cuda, n, B)
        return
    sp, iq = _zero_row_spectrum(cuda, n, B, seed=n + B)
    assert kernels.k6_route(n) == "split"
    before = dict(kernels.spectrum_fused.routes)
    _held_to_plain(kernels.spectrum_fused, kernels.spectrum_fused_plain,
                   sp, iq)
    assert kernels.spectrum_fused.routes == {**before,
                                             "split": before["split"] + 1}


def test_spectrum_dft_direct_route_past_the_split(cuda):
    """8 x 131968 = 8 x 128 x 1031: no split (1031 is past the core's
    primes), so the chirp route past 16384 points: M = 327680 = 512 x
    640, three launches through a (B, M) scratch."""
    _held_on_chirp_route(cuda, 131968, 8)


@pytest.mark.parametrize("n, B, M, cols, threads", [
    (2062, 37, 5120, None, 512),       # one launch, 512 threads, 3 rows
    (4099, 37, 10240, None, 512),      # one launch, 512 threads, 1 row
    (16411, 13, 40960, 256, 256),      # 256 x 160
    (262784, 2, 655360, 1024, 256),    # 128 x 2053: 1024 x 640
    (1310723, 2, 3145728, 2048, 256),  # 2048 x 1536
    (8388736, 2, 20971520, 4096, 512),  # 128 x 65537: 4096 x 5120
])
def test_spectrum_dft_chirp_route_on_every_instance(cuda, n, B, M, cols,
                                                    threads):
    """Every instance the chirp route can launch, beside the sizes above
    (1031: one launch on 256 threads; 16381 and 131968: columns of 128 and
    512 points, pass B on 256 threads): the one launch on 512 threads,
    the column passes on each other pow2 instance (256, 1024, 2048 and
    4096 points) and pass B on 512 threads.  Past a million points a row,
    held to the model of its steps and the float64 truth."""
    assert kernels.chirp_length(n) == M
    if cols is None:
        assert kernels._runtime_block(M)[0] == threads
    else:
        M1, M2 = kernels.chirp_split(M)
        assert M1 == cols and kernels._runtime_block(M2)[0] == threads
    _held_on_chirp_route(cuda, n, B, product=n * B <= 1 << 20)


@pytest.mark.parametrize("n", [1031, 16381])
@pytest.mark.parametrize("B", [1, 13])
def test_spectrum_dft_direct_product_on_a_forced_route(cuda, monkeypatch,
                                                       n, B):
    """The direct product (csrc/spectrum_dft.cu) still serves the n no
    other route takes; it is held at the sizes the chirp route took from
    it, with ``kernels.k6_route`` forced to "direct"."""
    monkeypatch.setattr(kernels, "k6_route", lambda n: "direct")
    sp, iq = _zero_row_spectrum(cuda, n, B, seed=n + B)
    before = dict(kernels.spectrum_fused.routes)
    _held_to_plain(kernels.spectrum_fused, kernels.spectrum_fused_plain,
                   sp, iq)
    assert kernels.spectrum_fused.routes == {
        **before, "direct": before["direct"] + 1}


def test_chirp_launchers_refuse_plans_they_do_not_hold(cuda):
    """The chirp route's launchers re-check their sizes, plans and blocks:
    M below 2 n - 1, a plan with a prime past 127 (the chirp instances
    hold no large-prime pass), a block whose rows do not fit (pass B's 7
    rows of 640 points), a split factor past 16384 and a column factor
    that is no power of two (the column passes run on the pow2 instances
    alone) are refused (CUDA error 1) before any launch, and the wrapper
    raises on a refusal rather than take another route."""
    one = kernels._fft_core_launcher("spectrum_chirp")
    three = kernels._fft_core_launcher("spectrum_chirp_split")
    n, B = 1031, 2
    sp, iq = _spectrum(cuda, n, B)
    out = torch.full((B, n), -1.0, device=cuda)
    scal = kernels._spectrum_scalars(sp._coeff, sp._scale, sp._offset)
    stream = torch.cuda.current_stream().cuda_stream

    def ptrs(M):
        return (iq.data_ptr(), sp._win.data_ptr(),
                kernels._chirp_table(n, cuda).data_ptr(),
                kernels._chirp_spectrum(n, M, cuda).data_ptr(),
                kernels._stockham_twiddles(M, cuda).data_ptr(),
                kernels._core_twiddles(M, cuda).data_ptr(), out.data_ptr(),
                B, n, M)

    M = kernels.chirp_length(n)
    assert M == 2560 and kernels._runtime_block(M) == (256, 1)
    plan = kernels._packed_plan(M)
    assert one(*ptrs(M), *plan, 256, 1, *scal, stream) == 0
    torch.cuda.synchronize()
    assert bool((out >= 0).all())
    out.fill_(-1.0)
    small = kernels._packed_plan(2048)                  # M < 2 n - 1
    assert one(*ptrs(2048), *small, 256, 2, *scal, stream) == 1
    large = kernels._packed_plan(2620)                  # 20 x 131
    assert one(*ptrs(2620), *large, 256, 1, *scal, stream) == 1
    assert one(*ptrs(M), *plan, 256, 2, *scal, stream) == 1
    M1, M2 = kernels.chirp_split(327680)
    y = torch.empty((B, 327680), dtype=torch.complex64, device=cuda)
    tabs = kernels._split_tables(M1, M2, cuda)
    args = (iq.data_ptr(), sp._win.data_ptr(),
            kernels._chirp_table(n, cuda).data_ptr(),
            kernels._chirp_spectrum(n, 327680, cuda).data_ptr(),
            *(t.data_ptr() for t in tabs), y.data_ptr(), out.data_ptr(), B,
            n)
    assert (M1, M2) == (512, 640)
    assert kernels._runtime_block(M2) == (256, 6)
    blocks = (*kernels._packed_plan(M1), *kernels._packed_plan(M2), 256, 6)
    assert three(*args, 32768, 10, *blocks, *scal, stream) == 1
    assert three(*args, M1, M2, *blocks[:3], *kernels._packed_plan(M2), 256,
                 7, *scal, stream) == 1
    assert three(*args, M2, M1, *kernels._packed_plan(M2),
                 *kernels._packed_plan(M1), *kernels._runtime_block(M1),
                 *scal, stream) == 1
    torch.cuda.synchronize()
    assert bool((out == -1.0).all())                    # nothing ran
    assert three(*args, M1, M2, *blocks, *scal, stream) == 0
    torch.cuda.synchronize()
    assert bool((out >= 0).all())
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kernels._launch("spectrum_fused", {"iq": iq}, None, one, *ptrs(M),
                        *plan, 256, 2, *scal)


def test_fft_core_launcher_refuses_plans_it_does_not_hold(cuda):
    """The launcher re-checks the plan and the block: a prime past 1021,
    a bit past the radix fields, a large prime asked of the 512-thread
    block, and a block whose tiles do not fit are refused (CUDA error
    1), and the wrapper raises on a refusal rather than take another
    route."""
    launch = kernels._fft_core_launcher("spectrum_fft")
    sp, iq = _spectrum(cuda, 2062, 2)                # 2 x 1031
    out = torch.empty((2, 2062), device=cuda)
    # fft_plan refuses 1031 too: tables the launcher never reads
    ptw = torch.zeros((2061, 2), device=cuda)
    tw = kernels._dft_twiddles(2062, cuda)
    scal = kernels._spectrum_scalars(sp._coeff, sp._scale, sp._offset)
    ptrs = (iq.data_ptr(), sp._win.data_ptr(), ptw.data_ptr(),
            tw.data_ptr(), out.data_ptr(), 2, 2062)
    stream = torch.cuda.current_stream().cuda_stream
    bits = kernels.PLAN_RADIX_BITS
    assert launch(*ptrs, 2, 2 | 1031 << bits, 0, 256, 1, *scal, stream) == 1
    n, lo, hi = kernels._packed_plan(1021)
    tw = kernels._core_twiddles(1021, cuda)
    ptrs = (iq.data_ptr(), sp._win.data_ptr(),
            kernels._stockham_twiddles(1021, cuda).data_ptr(),
            tw.data_ptr(), out.data_ptr(), 2, 1021)
    assert launch(*ptrs, n, lo | 1 << 63, hi, 256, 2, *scal, stream) == 1
    assert launch(*ptrs, n, lo, hi, 512, 2, *scal, stream) == 1
    assert kernels._runtime_block(1021) == (256, 2)
    assert launch(*ptrs, n, lo, hi, 256, 3, *scal, stream) == 1
    assert launch(*ptrs, n, lo, hi, 256, 2, *scal, stream) == 0
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kernels._launch("spectrum_fused", {"iq": iq}, None, launch, *ptrs,
                        n, lo, hi, 512, 2, *scal)


@pytest.mark.parametrize("n", [5, 384, 2048, 16256, 131, 1021, 2042])
def test_spectrum_dft_fft_route_matches_its_steps(cuda, n):
    """The kernel against the model of its passes (complex128 on the
    float32 tables): 1e-4."""
    sp, iq = _zero_row_spectrum(cuda, n, 13, seed=n)
    args = (sp._win, sp._coeff, sp._scale, sp._offset)
    got = kernels.spectrum_fused(iq, *args)
    ref = kernels.spectrum_fft_plain(iq, *args)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("m", range(1, 33))
def test_spectrum_ct4_matches_plain(cuda, m):
    """K5 at every m, on 13 rows: not a multiple of the rows a block
    holds for m < 8."""
    sp, iq = _zero_row_spectrum(cuda, 128 * m, 13, seed=m)
    _held_to_plain(kernels.spectrum_fused_ct4,
                   kernels.spectrum_fused_ct4_plain, sp, iq)


@pytest.mark.parametrize("name", ["spectrum_fused", "spectrum_fused_ct4"])
def test_spectrum_routes_reject_what_they_do_not_take(cuda, name):
    kernel = getattr(kernels, name)
    sp, iq = _spectrum(cuda, 384, 4)
    args = (sp._coeff, sp._scale, sp._offset)
    before = kernel.launches
    flat = torch.empty(iq.numel() + 1, device=cuda)
    odd = flat[1:].view(4, 384, 2)           # contiguous, 4 bytes off
    odd.copy_(iq)
    with pytest.raises(ValueError, match="aligned"):
        kernel(odd, sp._win, *args)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(iq.transpose(0, 1).contiguous().transpose(0, 1), sp._win,
               *args)
    with pytest.raises(ValueError, match="float32"):
        kernel(iq.double(), sp._win, *args)
    with pytest.raises(ValueError, match="win"):
        kernel(iq, sp._win[:128], *args)
    with pytest.raises(ValueError, match="win"):
        kernel(iq, sp._win.double(), *args)
    if name == "spectrum_fused_ct4":
        with pytest.raises(ValueError, match="n=4224"):
            kernel(torch.zeros((2, 4224, 2), device=cuda),
                   torch.zeros(4224, device=cuda), *args)
    assert kernel.launches == before


@pytest.mark.parametrize("config,kernel", [
    ({"algorithm": "dft"}, "spectrum_fused"),
    ({}, "spectrum_fused_ct4")])
def test_spectrum_route_flowgraph_on_the_card(cuda, config, kernel):
    """dti -> spectrum at n = 1536 (m = 12) launches K6 with algorithm
    dft, and K5 otherwise, once a cycle and nothing else."""
    from cyberether_tpu_torch import Flowgraph

    B, n = 37, 1536
    sp = SpectrumPipeline(fft_size=n, batches=B, device=cuda)
    fg = Flowgraph()
    fg.block_create("src", "dti", {"shape": [B, n], "dataType": "CF32"})
    fg.block_create("spec", "spectrum", config,
                    {"buffer": "${graph.src.output.buffer}"},
                    provider="pallas")
    wrappers = (kernels.spectrum_fused, kernels.spectrum_fused_ct4,
                kernels.spectrum_fused_ct5, kernels.fft_pallas)
    before = {w.__name__: w.launches for w in wrappers}
    plain = getattr(kernels, kernel + "_plain")
    for seed in (1, 2):
        x = sp.make_input(seed=seed, device=cuda)
        fg.block_module("src").attach_buffer(torch.view_as_complex(x))
        assert fg.compute()
        got = fg.scheduler.output_tensor("spec.spectrum")
        assert fg.scheduler.output_valid("spec.spectrum")
        ref = plain(x, sp._win, sp._coeff, sp._scale, sp._offset)
        assert float((got - ref).abs().max()) <= 1e-4
    assert {w.__name__: w.launches - before[w.__name__]
            for w in wrappers} == {w.__name__: 2 if w.__name__ == kernel
                                   else 0 for w in wrappers}
    fg.stop()


def _cplx(cuda, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(tuple(shape) + (2,)).astype(np.float32)
    return torch.view_as_complex(torch.from_numpy(x)).to(cuda)


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096])
def test_fft_pallas_matches_plain_and_truth(cuda, n):
    """37 rows: not a multiple of the rows a block holds for n < 4096."""
    x = _cplx(cuda, (37, n), seed=n)
    before = kernels.fft_pallas.launches
    got = kernels.fft_pallas(x)
    assert kernels.fft_pallas.launches == before + 1
    ref = kernels.fft_pallas_plain(x)
    truth = torch.fft.fft(x.to(torch.complex128))
    steps = kernels.stockham_fft_plain(x)
    torch.cuda.synchronize()
    assert got.shape == (37, n) and got.dtype == torch.complex64
    assert _rel(got, ref) <= 1e-5
    assert _rel(got.to(torch.complex128), truth) <= 1e-5
    assert _rel(got, steps) <= 1e-5


def test_fft_pallas_leading_dims(cuda):
    x = _cplx(cuda, (2, 3, 1024), seed=3)
    got = kernels.fft_pallas(x)
    assert got.shape == (2, 3, 1024)
    truth = torch.fft.fft(x.to(torch.complex128))
    assert _rel(got.to(torch.complex128), truth) <= 1e-5


def test_fft_pallas_rejects_what_it_does_not_take(cuda):
    x = _cplx(cuda, (4, 256), seed=4)
    before = kernels.fft_pallas.launches
    # a lazy conjugate: the memory still holds x
    with pytest.raises(ValueError, match="conjugate"):
        kernels.fft_pallas(x.conj())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fft_pallas(_cplx(cuda, (256, 4), seed=5).T)
    # a complex64 tensor 4 bytes off an 8-byte boundary
    raw = torch.empty(4 * 256 * 8 + 8, dtype=torch.uint8, device=cuda)
    odd = torch.empty(0, dtype=torch.complex64, device=cuda).set_(
        raw.untyped_storage()[4:4 + 4 * 256 * 8], 0, (4, 256), (256, 1))
    odd.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        kernels.fft_pallas(odd)
    with pytest.raises(ValueError, match="n=384"):
        kernels.fft_pallas(_cplx(cuda, (2, 384), seed=6))
    assert kernels.fft_pallas.launches == before


@pytest.mark.parametrize("forward", [True, False])
def test_fft_pallas_module_on_the_card(cuda, forward):
    """The module moves a first sample axis last (a copy: the kernel
    takes contiguous rows) and back, and conjugates physically for the
    backward transform."""
    from cyberether_tpu_torch.blocks.dsp import FftPallasModule
    from cyberether_tpu_torch.core.tensor import SignalAxes, TensorSpec
    from cyberether_tpu_torch.core.types import DataType, Device

    n, lanes = 1024, 5
    spec = TensorSpec((n, lanes), DataType.CF32, Device.CUDA,
                      SignalAxes(sample=0, batch=1))
    mod = FftPallasModule("fft/m", {"forward": forward}, {"signal": spec},
                          device=Device.CUDA)
    x = _cplx(cuda, (n, lanes), seed=7)
    before = kernels.fft_pallas.launches
    got = mod.apply({"signal": x}, None)[0]["signal"]
    assert kernels.fft_pallas.launches == before + 1
    x64 = x.to(torch.complex128)
    truth = torch.fft.fft(x64, dim=0) if forward \
        else torch.fft.ifft(x64, dim=0) * n
    torch.cuda.synchronize()
    assert got.shape == (n, lanes)
    assert _rel(got.to(torch.complex128), truth) <= 1e-5
    if not forward:
        # the round trip of tests/models/test_pallas_kernels.py:416-430
        f = torch.fft.fft(x64, dim=0).to(torch.complex64)
        back = mod.apply({"signal": f}, None)[0]["signal"]
        assert float((back - n * x).abs().max()) <= 1e-2


def _engine_plain(x, lo, hi):
    """The spectrum_engine chain in plain torch ops, with K3's plain
    version: cast to CF32, window x (-1)^k, FFT, 20 log10 |X| - 20 log10
    n (-inf where |X| = 0), then the range soft clip."""
    n = x.shape[-1]
    sign = 1.0 - 2.0 * (torch.arange(n, device=x.device) % 2)
    win = (blackman(n, device=x.device) * sign).to(torch.complex64)
    X = kernels.fft_pallas_plain(x.to(torch.complex64) * win)
    mag = X.abs()
    db = torch.where(mag == 0, -torch.inf,
                     20.0 * torch.log10(mag) + 20.0 * np.log10(1.0 / n))
    scale = 1.0 / (hi - lo)
    return 0.5 + 0.5 * torch.tanh(4.0 * (db * scale - lo * scale - 0.5))


def test_spectrum_engine_flowgraph_launches_k3(cuda):
    from cyberether_tpu_torch import Flowgraph
    from cyberether_tpu_torch.blocks.dsp import FftPallasModule

    B, n = 64, 2048
    fg = Flowgraph()
    fg.block_create("src", "dti", {"shape": [B, n], "dataType": "CF32"})
    fg.block_create("spec", "spectrum_engine",
                    {"enableScale": True, "rangeMin": -100,
                     "rangeMax": 0},
                    {"buffer": "${graph.src.output.buffer}"})
    assert isinstance(fg.block_module("spec", "fft"), FftPallasModule)
    before = (kernels.fft_pallas.launches,
              kernels.spectrum_fused_ct5.launches)
    for seed in (1, 2):
        x = _cplx(cuda, (B, n), seed=seed)
        x[3] = 0
        fg.block_module("src").attach_buffer(x)
        assert fg.compute()
        got = fg.scheduler.output_tensor("spec.buffer")
        ref = _engine_plain(x, -100.0, 0.0)
        assert fg.scheduler.output_valid("spec.buffer")
        assert float((got - ref).abs().max()) <= 1e-4
        assert torch.equal(got.argmax(-1), ref.argmax(-1))
        assert bool((got[3] == 0).all())
    assert (kernels.fft_pallas.launches,
            kernels.spectrum_fused_ct5.launches) == \
        (before[0] + 2, before[1])
    fg.stop()


# -- the ct routes: K10 spectrum_fused_ct and K11 spectrum_fused_ct3 ----------

CT_TOL = 1e-5                 # kernel vs plain: both run K5's arithmetic
CT_TRUTH_TOL = {"exact": 1e-4, "approx": 1e-4, "none": 1e-5}
CT_ROUTES = [("spectrum_fused_ct4", {}),
             ("spectrum_fused_ct", {}),
             ("spectrum_fused_ct", {"exact": False}),
             ("spectrum_fused_ct3", {}),
             ("spectrum_fused_ct3", {"ep": "approx"}),
             ("spectrum_fused_ct3", {"ep": "none"})]


def _ct_truth(iq, sp, ep, skip):
    """K10's and K11's function in float64, a yardstick independent of the
    plain versions, with t = 128 n1 + n2 and k = m k2 + k1: the windowed
    m-point DFT over n1 (with "s1": windowed chunk 0 for every k1), the
    twiddle W_n^(k1 n2) (not with "tw"), the 128-point DFT over n2 (not
    with "s2"), then the epilogue ``ep``: "exact" (log10, tanh), "none"
    (|X|^2) or "approx", the TPU kernel's exponent-bits log10 of float32
    |X|^2 (its cubic in float64) and its clamped Padé tanh, divided
    exactly."""
    B, n, _ = iq.shape
    m = n // 128
    x = (torch.view_as_complex(iq.double()) * sp._win.double()) \
        .reshape(B, m, 128)
    a = x[:, :1].expand(B, m, 128) if "s1" in skip else \
        torch.fft.fft(x, dim=1)
    if "tw" not in skip:
        k1n2 = torch.outer(torch.arange(m, device=iq.device),
                           torch.arange(128, device=iq.device)).double()
        a = a * torch.polar(torch.ones_like(k1n2), -2 * np.pi * k1n2 / n)
    y = a if "s2" in skip else torch.fft.fft(a, dim=2)
    mag2 = (y.abs() ** 2).transpose(1, 2).reshape(B, n)
    if ep == "none":
        return mag2
    if ep == "exact":
        db = 10.0 * torch.log10(mag2) + sp._coeff
    else:
        bits = mag2.float().view(torch.int32)
        e = (((bits >> 23) & 0xFF) - 126).double()
        f = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32).double()
        log2 = ((1.23149591368684 * f - 4.11852516267426) * f
                + 6.02197014179219) * f - 3.13396450166353 + e
        db = 10.0 * np.log10(2.0) * log2 + sp._coeff
    t = 4.0 * (db * sp._scale + sp._offset - 0.5)
    if ep == "exact":
        return 0.5 + 0.5 * torch.tanh(t)
    t = t.clamp(-4.5, 4.5)
    t2 = t * t
    return 0.5 + 0.5 * (t * (135135.0 + t2 * (17325.0 + t2 * (378.0 + t2)))
                        / (135135.0 + t2 * (62370.0 + t2 * (3150.0
                                                            + t2 * 28.0))))


def _ct_held_to_plain(name, kw, sp, iq):
    """Launch K10 or K11 once with ``kw`` and hold it to its plain
    version: within CT_TOL (|X|^2: of each row's max), the same argmax in
    every row, on the zero row B // 2 exactly 0 (exact epilogue, |X|^2)
    or the plain version's value (approx: ~1e-4, as in JAX); then to the
    float64 truth of the same epilogue and flags (kb = 1 here, so every
    flag is taken) within CT_TRUTH_TOL.  Returns the output."""
    kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    args = (sp._win, sp._coeff, sp._scale, sp._offset)
    before = kernel.launches
    got = kernel(iq, *args, **kw)
    assert kernel.launches == before + 1
    ref = plain(iq, *args, **kw)
    torch.cuda.synchronize()
    B, n = iq.shape[:2]
    assert got.shape == (B, n) and bool(torch.isfinite(got).all())
    err = (got - ref).abs()
    ep = kw.get("ep", "exact")
    if ep == "none":
        err = err / ref.amax(-1, keepdim=True).clamp_min(1e-30)
    assert float(err.max()) <= CT_TOL
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    zero = got[B // 2]
    if ep == "approx":
        assert float((zero - ref[B // 2]).abs().max()) <= CT_TOL
        assert 0.9e-4 <= float(zero.min()) and float(zero.max()) <= 1.3e-4
    else:
        assert bool((zero == 0.0).all())
    truth = _ct_truth(iq, sp, ep, kw.get("skip", ()))
    err = (got.double() - truth).abs()
    if ep == "none":
        err = err / truth.amax(-1, keepdim=True).clamp_min(1e-300)
    assert float(err.max()) <= CT_TRUTH_TOL[ep]
    return got


@pytest.mark.parametrize("m", range(1, 33))
@pytest.mark.parametrize("name,kw", CT_ROUTES)
def test_spectrum_ct_routes_match_plain(cuda, m, name, kw):
    """K5, K10 (both tiers) and K11 (each epilogue) at every m, on 37
    rows (not a multiple of the rows a block holds for m < 16): every
    register bucket of the ct kernel and the instance of m = 16 with its
    stage 1 compiled in."""
    sp, iq = _zero_row_spectrum(cuda, 128 * m, 37, seed=m)
    _ct_held_to_plain(name, kw, sp, iq)


@pytest.mark.parametrize("m", [1, 3, 12, 16, 32])
@pytest.mark.parametrize("ep", ["exact", "approx", "none"])
@pytest.mark.parametrize("skip", [("s1",), ("tw",), ("s2",),
                                  ("s1", "tw", "s2")])
def test_spectrum_ct3_skip_flags_match_plain(cuda, m, ep, skip):
    sp, iq = _zero_row_spectrum(cuda, 128 * m, 37, seed=m + 40)
    _ct_held_to_plain("spectrum_fused_ct3", {"ep": ep, "skip": skip},
                      sp, iq)


def test_spectrum_ct3_drops_s1_where_jax_does(cuda):
    """B = 16, m = 16, kb = 2: JAX's effective kb stays 2, so it ignores
    "s1"; at B = 12 its batch tile is 12 and kb falls to 1, so it takes
    "s1"."""
    for B, honoured in ((16, False), (12, True)):
        sp, iq = _zero_row_spectrum(cuda, 2048, B, seed=B)
        args = (sp._win, sp._coeff, sp._scale, sp._offset)
        got = kernels.spectrum_fused_ct3(iq, *args, kb=2, skip=("s1",))
        full = kernels.spectrum_fused_ct3(iq, *args, kb=2)
        s1 = kernels.spectrum_fused_ct3(iq, *args, skip=("s1",))
        assert torch.equal(got, s1 if honoured else full)
        assert not torch.equal(s1, full)


def test_spectrum_ct_routes_launch_their_own_kernel(cuda):
    """step_kernel(version="ct1") launches K10 alone, once a call, for
    either ``exact``, and makes a strided iq contiguous first; the
    wrappers refuse a strided iq."""
    sp, iq = _zero_row_spectrum(cuda, 1536, 9, seed=5)
    wrappers = (kernels.spectrum_fused, kernels.spectrum_fused_ct4,
                kernels.spectrum_fused_ct5, kernels.spectrum_fused_ct,
                kernels.spectrum_fused_ct3, kernels.fft_pallas)
    before = {w.__name__: w.launches for w in wrappers}
    strided = torch.cat([iq, iq], dim=1)[:, ::2]
    assert not strided.is_contiguous()
    ref = kernels.spectrum_fused_ct_plain(strided.contiguous(), sp._win,
                                          sp._coeff, sp._scale, sp._offset)
    for exact in (True, False):
        got = sp.step_kernel(strided, version="ct1", exact=exact,
                             stage2="x4", kb=4)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= CT_TOL
    assert {w.__name__: w.launches - before[w.__name__]
            for w in wrappers} == {w.__name__: 2 if w.__name__ ==
                                   "spectrum_fused_ct" else 0
                                   for w in wrappers}
    for kernel in (kernels.spectrum_fused_ct, kernels.spectrum_fused_ct3):
        with pytest.raises(ValueError, match="contiguous"):
            kernel(strided, sp._win, sp._coeff, sp._scale, sp._offset)


@pytest.mark.parametrize("name", ["spectrum_fused_ct", "spectrum_fused_ct3"])
def test_spectrum_ct_routes_reject_what_they_do_not_take(cuda, name):
    kernel = getattr(kernels, name)
    sp, iq = _spectrum(cuda, 384, 4)
    args = (sp._coeff, sp._scale, sp._offset)
    before = kernel.launches
    flat = torch.empty(iq.numel() + 1, device=cuda)
    odd = flat[1:].view(4, 384, 2)           # contiguous, 4 bytes off
    odd.copy_(iq)
    with pytest.raises(ValueError, match="aligned"):
        kernel(odd, sp._win, *args)
    with pytest.raises(ValueError, match="float32"):
        kernel(iq.double(), sp._win, *args)
    with pytest.raises(ValueError, match="win"):
        kernel(iq, sp._win[:128], *args)
    with pytest.raises(ValueError, match="n=4224"):
        kernel(torch.zeros((2, 4224, 2), device=cuda),
               torch.zeros(4224, device=cuda), *args)
    assert kernel.launches == before


@pytest.mark.parametrize("n", [128, 2048, 4096])
def test_fft_pallas_display_tier_is_the_exact_call(cuda, n):
    """exact=False launches K3's kernel and counts it: the same bits."""
    x = _cplx(cuda, (37, n), seed=n + 1)
    before = kernels.fft_pallas.launches
    display = kernels.fft_pallas(x, exact=False)
    assert kernels.fft_pallas.launches == before + 1
    exact = kernels.fft_pallas(x)
    torch.cuda.synchronize()
    assert torch.equal(display, exact)
    truth = torch.fft.fft(x.to(torch.complex128))
    assert _rel(display.to(torch.complex128), truth) <= 1e-5


# -- the model keywords on the card ----------------------------------------------

@pytest.mark.parametrize("demod_mode,decim_mode", [
    ("classic", "chunk"), ("classic", "sel"), ("classic", "none"),
    ("coherent", "chunk")])
def test_step_kernel_decim_modes_on_the_card(cuda, demod_mode, decim_mode):
    """decim_mode="none" launches K1 at decimation 1 and means over D on
    the card; every mode agrees with the CPU route."""
    m = Channelizer(channels=64, taps_per_branch=8, audio_decim=16,
                    sample_rate=128e6, device=cuda)
    iq = m.make_input_full(1024, seed=4, device=cuda)
    before = kernels.channelize_demod_decim.launches
    got, _ = m.step_kernel(m.init_state_v4(), iq, demod_mode=demod_mode,
                           decim_mode=decim_mode, atan_mode="fast3")
    assert kernels.channelize_demod_decim.launches == before + 1
    cpu = Channelizer(channels=64, taps_per_branch=8, audio_decim=16,
                      sample_rate=128e6, device="cpu")
    ref, _ = cpu.step_kernel(cpu.init_state_v4(), iq.cpu(),
                             demod_mode=demod_mode, decim_mode=decim_mode)
    torch.cuda.synchronize()
    assert got.shape == (64, 64)
    assert float((got.cpu() - ref).abs().max()) <= 1e-4


def test_step_dft_kernel_bf16_launches_k6(cuda):
    sp, iq = _spectrum(cuda, 384, 4)
    before = kernels.spectrum_fused.launches
    got = sp.step_dft_kernel(iq, bf16=True)
    assert kernels.spectrum_fused.launches == before + 1
    assert torch.equal(got, sp.step_dft_kernel(iq))


# -- the card-floor probes' kernels: K13, K14, K15 --------------------------------

def _probe_rows(cuda, rows, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((rows, 128), device=cuda, generator=g)


@pytest.mark.parametrize("rows", [1, 37, 4096])
@pytest.mark.parametrize("rows_per_block", [1, 16, 2048])
@pytest.mark.parametrize("s", [2.0, 1.0])
def test_k13_scale_copy_is_its_plain_version(cuda, rows, rows_per_block, s):
    from cyberether_tpu_torch.ops import probe_kernels as pk

    x = _probe_rows(cuda, rows, rows)
    before = pk.scale_copy.launches
    got = pk.scale_copy(x, s, rows_per_block)
    assert pk.scale_copy.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, pk.scale_copy_plain(x, s))


@pytest.mark.parametrize("rows", [1, 37, 4096, 131072])
@pytest.mark.parametrize("stage_bytes", [16, 4096, 16384, 32768, 65536,
                                         113 * 1024])
def test_k14_staged_copy_copies(cuda, rows, stage_bytes):
    """Bit for bit at every stage size of the stream probe, 16 bytes, and
    the largest (a ring of 2 stages; 3 at 64 KB, else 4), on 1 row (one
    chunk), 37 rows (a chunk cut short) and up to the probe's width."""
    from cyberether_tpu_torch.ops import probe_kernels as pk

    x = _probe_rows(cuda, rows, rows + 1)
    before = pk.staged_copy.launches
    got = pk.staged_copy(x, stage_bytes)
    assert pk.staged_copy.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, x)


K15_MODES = ["fp32", "tf32", "3xtf32", "bf16", "f16"]


def _k15_held_to_plain(cuda, rows, mode, rows_per_block, seed):
    """Launch K15 once and hold it to its plain version: 1e-5 of max|o|
    (the plain version rounds the inputs as the mode does and sums its
    products in float64); the float32 modes also to the float64 product
    of the unrounded inputs (tf32 within 2e-3 and more than 1e-5 from
    it, so its rounding is not skipped)."""
    from cyberether_tpu_torch.ops import probe_kernels as pk

    dtype = pk.TILE_DOT_MODES[mode][1]
    x = _probe_rows(cuda, rows, seed).to(dtype)
    b = _probe_rows(cuda, 128, seed + 1).to(dtype)
    before = pk.tile_dot.launches[mode]
    got = pk.tile_dot(x, b, mode, rows_per_block=rows_per_block)
    assert pk.tile_dot.launches[mode] == before + 1
    ref = pk.tile_dot_plain(x, b, mode)
    torch.cuda.synchronize()
    assert got.shape == (rows, 128) and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if dtype == torch.float32:
        truth = x.double() @ b.double()
        err = float((got.double() - truth).abs().max()
                    / truth.abs().max())
        assert err <= (2e-3 if mode == "tf32" else 1e-5)
        if mode == "tf32":
            assert err > 1e-5


@pytest.mark.parametrize("rows_per_block", [128, 512, 2048])
@pytest.mark.parametrize("rows", [1, 37, 64, 65, 256, 4096, 131073])
@pytest.mark.parametrize("mode", K15_MODES)
def test_k15_tile_dot_matches_plain(cuda, rows, mode, rows_per_block):
    """Rows that leave a 64-row tile ragged (1, 37), fill one (64), or
    pass one by a row (65, 131073: the probe's rows and one), at each of
    the probe's rows a block: TMA's zero rows past the end are neither
    stored nor summed into a row that is."""
    _k15_held_to_plain(cuda, rows, mode, rows_per_block, rows + 2)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_k15_rejects_a_view_tma_cannot_read(cuda, mode):
    """x's tiles arrive by TMA, which needs a 16-byte aligned start: a
    view 4 or 2 bytes off raises before any launch; one 16 bytes off
    runs."""
    from cyberether_tpu_torch.ops import probe_kernels as pk

    dtype = pk.TILE_DOT_MODES[mode][1]
    per16 = 16 // dtype.itemsize
    flat = _probe_rows(cuda, 66, 5).to(dtype).reshape(-1)
    b = _probe_rows(cuda, 128, 6).to(dtype)
    before = pk.tile_dot.launches[mode]
    for off in range(1, per16):
        with pytest.raises(ValueError, match="16-byte aligned"):
            pk.tile_dot(flat[off:off + 65 * 128].view(65, 128), b, mode)
    assert pk.tile_dot.launches[mode] == before
    x = flat[per16:per16 + 65 * 128].view(65, 128)
    got = pk.tile_dot(x, b, mode)
    ref = pk.tile_dot_plain(x, b, mode)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_probe_kernels_reject_what_they_do_not_take(cuda):
    from cyberether_tpu_torch.ops import probe_kernels as pk

    flat = torch.zeros(4 * 128 + 1, device=cuda)
    odd = flat[1:].view(4, 128)              # contiguous, 4 bytes off
    before = (pk.scale_copy.launches, pk.staged_copy.launches,
              sum(pk.tile_dot.launches.values()))
    for call in (lambda: pk.scale_copy(odd), lambda: pk.staged_copy(odd),
                 lambda: pk.tile_dot(odd, torch.zeros((128, 128),
                                                      device=cuda))):
        with pytest.raises(ValueError, match="aligned"):
            call()
    with pytest.raises(ValueError, match="contiguous"):
        pk.scale_copy(torch.zeros((128, 8), device=cuda).T)
    with pytest.raises(ValueError, match="share one device"):
        pk.tile_dot(torch.zeros((64, 128), device=cuda),
                    torch.zeros((128, 128)))
    assert (pk.scale_copy.launches, pk.staged_copy.launches,
            sum(pk.tile_dot.launches.values())) == before


# -- K16 channelize_ablate, K17 wbfm_ablate --------------------------------------

def _ablate_check(got, ref, angles, values) -> None:
    """Angle columns within 1e-4, the other columns within 1e-5 of their
    max|o| (``angles``/``values``: a column slice or None)."""
    torch.cuda.synchronize()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    if angles is not None:
        assert float((got[..., angles] - ref[..., angles]).abs().max()) \
            <= 1e-4
    if values is not None:
        assert float((got[..., values] - ref[..., values]).abs().max()
                     / ref[..., values].abs().max()) <= 1e-5


@pytest.mark.parametrize("chunks", [5, 400])
@pytest.mark.parametrize("C,P,D", [(8, 4, 4), (64, 8, 16)])
@pytest.mark.parametrize("stage", kernels.CHANNELIZE_ABLATE_STAGES)
def test_k16_channelize_ablate_matches_plain(cuda, C, P, D, stage, chunks):
    """Each instance of K1's tensor-core template on a non-zero history
    and a ragged last chunk (full_rate: a length that is no multiple of
    D); at 400 chunks each persistent block walks several and carries its
    lag frame from one to the next."""
    m = Channelizer(channels=C, taps_per_branch=P, audio_decim=D,
                    sample_rate=C * 2e6, device=cuda)
    M = 128 * chunks + 2 * D + (3 if stage == "full_rate" else 0)
    frames = m.make_input_full(M + P, seed=C, device=cuda).reshape(
        M + P, 2 * C)
    x, h = frames[P:].contiguous(), frames[:P].contiguous()
    inst = kernels.CHANNELIZE_ABLATE_INSTANCE_OF[stage]
    before = kernels.channelize_ablate.launches[inst]
    got = kernels.channelize_ablate(x, h, m.hp5, m.bperm5, m.fm_ref, D,
                                    stage)
    assert kernels.channelize_ablate.launches[inst] == before + 1
    ref = kernels.channelize_ablate_plain(x, h, m.hp5, m.bperm5, m.fm_ref,
                                          D, stage)
    every = slice(None)
    if stage == "full_rate":
        assert got.shape == (M, 2 * C)
        _ablate_check(got, ref, slice(0, C), slice(C, None))
    elif stage in ("full", "no_fir", "reshape_mean"):
        _ablate_check(got, ref, every, None)
    else:
        _ablate_check(got, ref, None, every)


def test_k16_full_is_k9_function_on_the_card(cuda):
    m = Channelizer(channels=64, taps_per_branch=8, audio_decim=16,
                    device=cuda)
    x = m.make_input_full(4096, seed=5, device=cuda).reshape(4096, 128)
    h = torch.zeros((8, 128), device=cuda)
    got = kernels.channelize_ablate(x, h, m.hp5, m.bperm5, m.fm_ref, 16)
    k9 = kernels.channelize_demod_decim_v6(x, h, m.hp5, m.bperm5, m.fm_ref,
                                           16)
    torch.cuda.synchronize()
    # the same sums; K9 refines an approximate reciprocal where K16 divides
    assert float((got - k9).abs().max()) <= 1e-5


def test_k16_rejects_what_it_does_not_take(cuda):
    m = Channelizer(channels=16, taps_per_branch=4, audio_decim=4,
                    sample_rate=32e6, device=cuda)
    x, h = torch.zeros((256, 32), device=cuda), torch.zeros((4, 32),
                                                            device=cuda)
    with pytest.raises(ValueError, match="built for C"):
        kernels.channelize_ablate(x, h, m.hp5, m.bperm5, m.fm_ref, 4)
    with pytest.raises(ValueError, match="stage"):
        kernels.channelize_ablate(x, h, m.hp5, m.bperm5, m.fm_ref, 4,
                                  "k_full")


@pytest.mark.parametrize("n,T", [(128 * 37, 129), (4096, 9),
                                 (1 << 20, 129)])
@pytest.mark.parametrize("stage", kernels.WBFM_ABLATE_STAGES)
def test_k17_wbfm_ablate_matches_plain(cuda, n, T, stage):
    """On the receiver's FM input: the lag angles of noise come near pi,
    where a rounding flips an angle by 2 pi."""
    rx = WbfmReceiver(taps=T, device=cuda)
    x = rx.make_input(n, seed=n + T, device=cuda).T.contiguous()
    h = rx.make_input(2 * T, seed=1, device=cuda)[-(T - 1):].T.contiguous()
    inst = kernels.WBFM_ABLATE_INSTANCE_OF[stage]
    before = kernels.wbfm_ablate.launches[inst]
    got = kernels.wbfm_ablate(x, rx._taps, h, rx._ref, stage)
    assert kernels.wbfm_ablate.launches[inst] == before + 1
    ref = kernels.wbfm_ablate_plain(x, rx._taps, h, rx._ref, stage)
    every = slice(None)
    if inst == "full":
        _ablate_check(got, ref, every, None)
    else:
        _ablate_check(got, ref, None, every)


def test_k17_full_is_k12_bit_for_bit(cuda):
    """One instance: K17's full and K12 run the same kernel."""
    rx = WbfmReceiver(device=cuda)
    x = rx.make_input(1 << 18, seed=4, device=cuda).T.contiguous()
    h = torch.zeros((2, rx._taps.shape[0] - 1), device=cuda)
    assert torch.equal(kernels.wbfm_ablate(x, rx._taps, h, rx._ref),
                       kernels.wbfm_fused(x, rx._taps, h, rx._ref))
