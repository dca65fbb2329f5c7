"""The Stockham FFT core of K3 (``fft_pallas``) and K6's FFT route
(``spectrum_fused``) on the CPU: its plan, its route, and a plain model of
its passes against numpy and the JAX package.  JAX's Pallas kernels run
in interpret mode.

- ``fft_plan(n)``: for every n in 1..128 and n = 128 m, m in 1..130, the
  radices multiply to n and are the kernel's (16, 8, 4, 2, 3, 5, 7 in
  registers, any other prime <= 127 as a direct stage); a power of two
  from 128 to 16384 takes the split the kernel compiles in.
  ``k6_route(n)`` is "fft" exactly for n <= 16384 whose prime factors are
  all <= 127 (every n <= 128, and 128 m for m <= 128) but five past 16256,
  where no runtime-plan block (``_runtime_block``) holds a prime pass.
- ``k6_split(n)`` for every n = 128 m, m in 129..1024: the most balanced
  pair n1 <= n2 of factors the core takes each, and None exactly where m
  has a prime factor past 127; ``k6_route`` is "split" where there is a
  pair and "direct" where there is none.  No factor is a power of two
  past ``SPLIT_MAX_POW2``, the largest pow2 instance the split's passes
  build (``kSplitMaxLog2`` in csrc/spectrum_fft.cu).
- ``split_fft_plain``, the split route's two passes (n1-point columns,
  the twiddle W_n^(t2 k1), n2-point rows): within 1e-5 of max|X| of
  numpy's complex128 FFT at forced splits, either factor a power of two,
  a register radix or a runtime plan.
- ``stockham_fft_plain``, the passes with the plan and the kernel's table
  indices: within 1e-5 of max|X| of numpy's complex128 FFT at every n
  above, and of JAX's ``fft_pallas`` at K3's sizes (the JAX tests' bar
  for ``fft_pallas``).
- K6's epilogue on it (``spectrum_fft_plain``): within 2e-4 of JAX's
  ``spectrum_fused`` (the bar of the full DFT's float32 products at the
  display's deep nulls), and within 1e-4 of a float64 truth, with the
  same argmax bin in every live row at n >= 5 (below, the tone at 0.1 of
  the rate sits between two bins of equal weight) and exactly 0 on a zero
  row.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyberether_tpu.models.spectrum import SpectrumPipeline as JaxSpectrum
from cyberether_tpu.ops import pallas_kernels as jk
from cyberether_tpu_torch import convert
from cyberether_tpu_torch.models.spectrum import SpectrumPipeline
from cyberether_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

PLAN_SIZES = list(range(1, 129)) + [128 * m for m in range(1, 131)]
K3_SIZES = [128, 256, 512, 1024, 2048, 4096]
REGISTER_RADICES = {2, 3, 4, 5, 7, 8, 16}
REL = 1e-5
ZERO_ROW = 3


def _is_prime(p: int) -> bool:
    return p > 1 and all(p % d for d in range(2, int(p ** 0.5) + 1))


def _largest_prime_factor(n: int) -> int:
    best, d = 1, 2
    while n > 1:
        while n % d == 0:
            best, n = d, n // d
        d += 1
    return best


def _cplx(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# -- the plan and the route ---------------------------------------------------

@pytest.mark.parametrize("n", PLAN_SIZES)
def test_plan_multiplies_to_n_with_the_kernels_radices(n):
    plan = tk.fft_plan(n)
    assert int(np.prod(plan, dtype=np.int64)) == n
    assert all(r in REGISTER_RADICES or (_is_prime(r) and r <= 127)
               for r in plan)
    fft = n <= 16384 and _largest_prime_factor(n) <= 127
    # past 16384 points (m = 129, 130) the split route takes 128 m
    assert tk.k6_route(n) == ("fft" if fft else "split" if n > 16384
                              else "direct")
    # what the block admits: any n <= 128, and 128 m for m <= 128
    assert fft == (n <= 128 or (n % 128 == 0 and n // 128 <= 128))


@pytest.mark.parametrize("log2n", range(7, 15))
def test_plan_of_a_power_of_two_is_the_compiled_split(log2n):
    """ceil(log2 n / 4) passes, the bits as even as they go, larger
    first: what csrc/spectrum_fft.cu's Pow2<log2 n> compiles in."""
    passes = -(-log2n // 4)
    bits = [log2n // passes + (p < log2n % passes) for p in range(passes)]
    assert tk.fft_plan(1 << log2n) == tuple(1 << b for b in bits)
    assert tk.fft_plan(2048) == (16, 16, 8)


def test_plan_packs_into_two_words_and_refuses_large_primes():
    assert tk._packed_plan(1) == (0, 0, 0)
    assert tk._packed_plan(1536) == (4, 8 | 8 << 8 | 8 << 16 | 3 << 24, 0)
    count, lo, hi = tk._packed_plan(128 * 81)            # 6 passes
    assert count == 6 and hi == 0
    assert [(lo >> (8 * i)) & 0xFF for i in range(count)] == \
        list(tk.fft_plan(128 * 81))
    with pytest.raises(ValueError, match="131"):
        tk.fft_plan(131)
    with pytest.raises(ValueError):
        tk.fft_plan(0)
    assert [tk.k6_route(n) for n in (131, 262, 16512, 16384, 16256,
                                     16768)] == \
        ["direct", "direct", "split", "fft", "fft", "direct"]


RUNTIME_SIZES = [n for n in PLAN_SIZES
                 if n <= 16384 and (n < 128 or n & (n - 1))]
NO_BLOCK = [16261, 16350, 16362, 16371, 16383]


def _block_fits(n, threads, values, rows):
    return rows * n <= values * threads and all(
        -(-rows * (n // p) // 4) * ((p - 1) // 2) <= values // 8 * threads
        for p in tk.fft_plan(n) if p not in tk.FFT_REGISTER_RADICES)


@pytest.mark.parametrize("n", RUNTIME_SIZES)
def test_runtime_block_holds_every_pass(n):
    """The runtime-plan block for n: 256 threads of 16 values, or 512 of 32
    where the first holds no row, with as many rows as fit both the values
    and, for each prime pass p > 7, its ceil(rows n / (4 p)) (p - 1) / 2
    items at values / 8 a thread: what csrc/spectrum_fft.cu's
    any_block_valid accepts."""
    threads, rows = tk._runtime_block(n)
    values = dict(tk.FFT_ANY_BLOCKS)[threads]
    assert rows >= 1 and _block_fits(n, threads, values, rows)
    assert not _block_fits(n, threads, values, rows + 1)
    assert threads == 256 or not _block_fits(n, 256, 16, 1)
    if n <= 4096 and max(tk.fft_plan(n), default=1) <= 16:
        assert (threads, rows) == (256, 4096 // n)


def test_k6_route_is_direct_only_where_no_block_holds_a_row():
    """Of every n <= 16384 whose primes are all <= 127, the FFT route
    leaves to the direct product only the few past 16256 whose prime pass
    fills no block."""
    direct = [n for n in range(1, 16385)
              if _largest_prime_factor(n) <= 127
              and tk.k6_route(n) == "direct"]
    assert direct == NO_BLOCK
    assert all(tk._runtime_block(n) is None for n in NO_BLOCK)


def _fft_pair(n1, n2):
    """Both factors on the FFT route, neither a power of two past the
    split's pow2 instances."""
    return all(tk.k6_route(f) == "fft"
               and (f & (f - 1) or f <= tk.SPLIT_MAX_POW2) for f in (n1, n2))


@pytest.mark.parametrize("m", range(129, 1025))
def test_k6_split_past_16384_points(m):
    """n = 128 m: (n1, n2) multiply to n, each factor on the FFT route,
    n1 the largest such factor <= sqrt(n) (the most balanced pair); None,
    and the direct route, exactly where m has a prime factor past 127."""
    n = 128 * m
    pair = tk.k6_split(n)
    if _largest_prime_factor(m) > 127:
        assert pair is None and tk.k6_route(n) == "direct"
        return
    n1, n2 = pair
    assert n1 * n2 == n and 2 <= n1 <= n2 and _fft_pair(n1, n2)
    assert not any(n % d == 0 and _fft_pair(d, n // d)
                   for d in range(n1 + 1, int(n ** 0.5) + 1))
    assert tk.k6_route(n) == "split"


def test_k6_split_examples():
    assert [tk.k6_split(n) for n in (16512, 32768, 65536, 131072, 16768)] \
        == [(128, 129), (128, 256), (256, 256), (256, 512), None]


def test_k6_split_takes_no_power_of_two_past_the_built_instances():
    """The split's largest pow2 factor is the launcher's kSplitMaxLog2; a
    pair that would need a larger one gives way to the next balanced pair,
    or to the direct route where there is none."""
    src = (Path(tk.__file__).parent.parent / "csrc" / "spectrum_fft.cu") \
        .read_text()
    log2 = int(re.search(r"kSplitMaxLog2 = (\d+);", src).group(1))
    assert tk.SPLIT_MAX_POW2 == 1 << log2 == 4096
    assert tk.k6_split(4288 * 8192) == (4096, 8576)
    assert tk.k6_split(1 << 25) is None and tk.k6_route(1 << 25) == "direct"


@pytest.mark.parametrize("n", [2, 100, 384, 2048, 16256])
def test_pass_twiddles_are_table_entries_in_pass_order(n):
    """Entry r Ns + k - 1 of the passes' table is the n-entry table's
    W_n^(r k n / (Ns R)), bit for bit; the passes fill n - 1 entries."""
    dev = torch.device("cpu")
    tw = tk._dft_twiddles(n, dev).numpy()
    ptw = tk._stockham_twiddles(n, dev).numpy()
    assert ptw.shape == (n - 1, 2)
    ns = 1
    for R in tk.fft_plan(n):
        for r in range(1, R):
            k = np.arange(ns)
            np.testing.assert_array_equal(ptw[r * ns + k - 1],
                                          tw[r * k * (n // (ns * R))])
        ns *= R


# -- the passes against numpy and JAX ----------------------------------------

@pytest.mark.parametrize("n", PLAN_SIZES)
def test_stockham_passes_match_numpy(n):
    x = _cplx(n, (3, n))
    got = tk.stockham_fft_plain(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and got.dtype == np.complex64
    assert _rel(got, np.fft.fft(x.astype(np.complex128))) <= REL


@functools.lru_cache(maxsize=None)
def _k3_case(n):
    x = _cplx(n + 1, (4, n))
    return x, np.asarray(jk.fft_pallas(jnp.asarray(x), interpret=True))


@pytest.mark.parametrize("n", K3_SIZES)
def test_stockham_passes_match_jax_fft_pallas(n):
    x, ref = _k3_case(n)
    got = tk.stockham_fft_plain(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) <= REL
    # and K3's plain version, the kernel's reference on the card
    assert _rel(got, tk.fft_pallas_plain(torch.from_numpy(x)).numpy()) \
        <= REL


@pytest.mark.parametrize("n1,n2", [(8, 16), (3, 128), (128, 3), (16, 129),
                                   (128, 129)])
def test_split_passes_match_numpy(n1, n2):
    """The split route's passes at forced splits: a power of two on
    either side, a register radix (3) and a runtime plan (129 = 3 x 43,
    a direct 43-point pass)."""
    x = _cplx(n1 + n2, (3, n1 * n2))
    got = tk.split_fft_plain(torch.from_numpy(x), n1, n2).numpy()
    assert got.shape == x.shape and got.dtype == np.complex64
    assert _rel(got, np.fft.fft(x.astype(np.complex128))) <= REL


def test_split_passes_refuse_a_wrong_pair():
    with pytest.raises(ValueError, match="not n"):
        tk.split_fft_plain(torch.zeros((1, 384), dtype=torch.complex64),
                           16, 16)


def test_stockham_passes_keep_leading_dims():
    x = _cplx(7, (2, 3, 384))
    got = tk.stockham_fft_plain(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 384)
    assert _rel(got, np.fft.fft(x.astype(np.complex128))) <= REL


# -- K6's epilogue on the passes: the display bars ----------------------------

def _pair(n, batches):
    """A JAX pipeline and a port pipeline on the CPU computing with the
    JAX pipeline's constants."""
    j = JaxSpectrum(fft_size=n, batches=batches, fast_math=False)
    t = SpectrumPipeline(fft_size=n, batches=batches, device="cpu")
    t.load_params(convert.spectrum_params_from_arrays(
        {"win": np.asarray(j._win), "coeff": j._coeff, "scale": j._scale,
         "offset": j._offset}, device="cpu"))
    return j, t


def _input(n, batches, seed):
    iq = JaxSpectrum(fft_size=n, batches=batches).make_input(seed=seed)
    iq[min(ZERO_ROW, batches - 1)] = 0.0
    return iq


def _truth(iq, j):
    x = (iq[..., 0].astype(np.float64) + 1j * iq[..., 1]) \
        * np.asarray(j._win, np.float64)
    with np.errstate(divide="ignore"):
        db = 10.0 * np.log10(np.abs(np.fft.fft(x, axis=-1)) ** 2) \
            + float(j._coeff)
    return 0.5 + 0.5 * np.tanh(
        4.0 * (db * float(j._scale) + float(j._offset) - 0.5))


def _steps(iq, t):
    return tk.spectrum_fft_plain(torch.from_numpy(iq), t._win, t._coeff,
                                 t._scale, t._offset).numpy()


@pytest.mark.parametrize("n", [5, 64, 100, 127, 256, 384])
def test_steps_with_k6_epilogue_match_jax_spectrum_fused(n):
    """B = 8: JAX's K6 takes B % min(128, B) == 0."""
    j, t = _pair(n, 8)
    iq = _input(n, 8, seed=n)
    ref = np.asarray(j.step_pallas(jnp.asarray(iq), interpret=True))
    got = _steps(iq, t)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 2e-4
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()
    assert (got[ZERO_ROW] == 0.0).all()


@pytest.mark.parametrize("n,batches", [
    (1, 3), (2, 3), (3, 3), (5, 3), (7, 3), (64, 4), (100, 4), (127, 4),
    (128, 4), (384, 4), (1536, 4), (2048, 4), (4224, 2), (8192, 2),
    (12288, 2), (16256, 2), (16384, 2)])
def test_steps_with_k6_epilogue_match_f64_truth(n, batches):
    j, t = _pair(n, batches)
    zero = min(ZERO_ROW, batches - 1)
    iq = _input(n, batches, seed=n + 1)
    got, truth = _steps(iq, t), _truth(iq, j)
    assert got.shape == (batches, n) and np.isfinite(got).all()
    assert np.abs(got - truth).max() <= 1e-4
    assert (got[zero] == 0.0).all()
    live = np.arange(batches) != zero
    if n >= 5:
        assert (np.argmax(got[live], -1) == np.argmax(truth[live], -1)).all()


def test_k6_wrapper_on_cpu_runs_plain_and_counts_no_route():
    _, t = _pair(384, 2)
    iq = torch.from_numpy(_input(384, 2, seed=1))
    args = (t._win, t._coeff, t._scale, t._offset)
    before = (tk.spectrum_fused.launches, dict(tk.spectrum_fused.routes))
    got = tk.spectrum_fused(iq, *args)
    assert torch.equal(got, tk.spectrum_fused_plain(iq, *args))
    assert (tk.spectrum_fused.launches, tk.spectrum_fused.routes) == before
    assert set(tk.spectrum_fused.routes) == {"fft", "split", "direct"}
