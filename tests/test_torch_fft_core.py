"""The Stockham FFT core of K3 (``fft_pallas``) and K6's FFT route
(``spectrum_fused``) on the CPU: its plan, its route, and a plain model of
its passes against numpy and the JAX package.  JAX's Pallas kernels run
in interpret mode.

- ``fft_plan(n)``: for every n in 1..128 and n = 128 m, m in 1..130, the
  radices multiply to n and are the kernel's (16, 8, 4, 2, 3, 5, 7 in
  registers, any other prime <= 1021 as a direct stage); a power of two
  from 128 to 16384 takes the split the kernel compiles in.  The plan
  packs into two words of 10-bit fields and back, for every prime up to
  1021, and a prime past 1021 is refused.  ``k6_route(n)`` is "fft" for
  n <= 16384 whose prime factors are all <= 1021 where a runtime-plan
  block (``_runtime_block``) holds every pass, "split" for every other n
  with such primes (five past 16256 among them), "chirp" past a prime of
  1021 (Bluestein's transform over ``chirp_length(n)``), and "direct"
  only where no convolution length exists (n past 25165824 that does
  not split, such as 2^25).
- ``k6_split(n)`` for every n = 128 m, m in 129..1024: the most balanced
  pair n1 <= n2 of factors the core takes each, for every m;
  ``k6_route`` is "split" there.  No factor is a power of two past
  ``SPLIT_MAX_POW2``, the largest pow2 instance the split's passes build
  (``kSplitMaxLog2`` in csrc/spectrum_fft.cu).
- The large-prime pass (a prime from 131 to 1021): its block holds every
  pass (``_large_pass_fits``, the launcher's check), and its tables
  (``_core_twiddles``: cos and sin in Rader's order, the powers of a
  primitive root) give the p-point DFT, in float64 on the float32
  tables, within 1e-6 of max|X| of numpy's.
- ``split_fft_plain``, the split route's two passes (n1-point columns,
  the twiddle W_n^(t2 k1), n2-point rows): within 1e-5 of max|X| of
  numpy's complex128 FFT at forced splits, either factor a power of two,
  a register radix or a runtime plan.
- ``stockham_fft_plain``, the passes with the plan and the kernel's table
  indices: within 1e-5 of max|X| of numpy's complex128 FFT at every n
  above, and of JAX's ``fft_pallas`` at K3's sizes (the JAX tests' bar
  for ``fft_pallas``).
- K6's chirp route: ``chirp_length(n)`` is the least m 2^a >= 2 n - 1
  (m = 1, 3, 5) whose transforms the route takes, at every n <= 16384
  with a prime past 1021; ``chirp_split(M)`` puts a power of two from
  128 to 4096 on the column passes of every such M the split route
  takes, and splits no other; the chirp table, its phase from t^2 mod 2 n in
  int64, is within one float32 ulp of a float64 truth at n = 131968,
  where a float32 t^2 is not; ``chirp_fft_plain``, the route's steps in
  complex128 on the float32 tables, is within 1e-5 of max|X| of numpy's
  complex128 FFT at n = 1031, 2062, 16381 and 131968.
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
    assert all(r in REGISTER_RADICES or
               (_is_prime(r) and r <= tk.FFT_MAX_PRIME) for r in plan)
    fft = n <= 16384 and _largest_prime_factor(n) <= tk.FFT_MAX_PRIME
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


def _unpacked(count, lo, hi):
    """The radices of a packed plan: 10-bit fields, six a word."""
    bits, per = tk.PLAN_RADIX_BITS, tk.PLAN_RADICES_A_WORD
    return [((lo, hi)[i // per] >> (bits * (i % per))) & ((1 << bits) - 1)
            for i in range(count)]


def test_plan_packs_into_two_words_and_refuses_large_primes():
    assert tk._packed_plan(1) == (0, 0, 0)
    assert tk._packed_plan(1536) == (4, 8 | 8 << 10 | 8 << 20 | 3 << 30, 0)
    count, lo, hi = tk._packed_plan(128 * 81)            # 6 passes
    assert count == 6 and hi == 0
    assert _unpacked(count, lo, hi) == list(tk.fft_plan(128 * 81))
    count, lo, hi = tk._packed_plan(2 * 3 ** 8)          # 9: the high word
    assert count == 9 and hi == 3 | 3 << 10 | 3 << 20
    assert _unpacked(count, lo, hi) == list(tk.fft_plan(2 * 3 ** 8))
    assert max(lo, hi) < 1 << 60                         # 4 bits spare
    with pytest.raises(ValueError, match="two words"):
        tk._packed_plan(3 ** 13)                         # 13 passes
    with pytest.raises(ValueError, match="1031"):
        tk.fft_plan(1031)
    with pytest.raises(ValueError):
        tk.fft_plan(0)
    assert [tk.k6_route(n) for n in (131, 262, 16512, 16384, 16256,
                                     16768, 1031, 131968)] == \
        ["fft", "fft", "split", "fft", "fft", "split", "chirp", "chirp"]


@pytest.mark.parametrize("p", [131, 257, 509, 1021])
@pytest.mark.parametrize("m", [1, 2, 8, 128])
def test_plan_packing_round_trips_large_primes(p, m):
    """n = m p: the pow2 passes, then p, each field back as it went in."""
    plan = tk.fft_plan(m * p)
    assert plan[-1] == p and int(np.prod(plan)) == m * p
    count, lo, hi = tk._packed_plan(m * p)
    assert _unpacked(count, lo, hi) == list(plan)


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
    """Of every n <= 16384 whose primes are all <= 1021, none runs the
    direct product: where no runtime-plan block holds the row (the few
    past 16256 whose prime pass fills no block, and large primes past
    8192 points) the split route takes it; the n with a prime past 1021
    take the chirp route, and none runs the direct product."""
    routes = {n: tk.k6_route(n) for n in range(1, 16385)}
    largest = {n: _largest_prime_factor(n) for n in routes}
    held = [n for n in routes if largest[n] <= 1021]
    assert [n for n in held if routes[n] == "direct"] == []
    assert all(routes[n] == "chirp" for n in routes if largest[n] > 1021)
    assert all((routes[n] == "fft") == (tk._runtime_block(n) is not None
                                        or n >= 128 and n & (n - 1) == 0)
               for n in held)
    assert all(tk._runtime_block(n) is None and routes[n] == "split"
               for n in NO_BLOCK)


LARGE_PRIMES = [p for p in range(128, 1022) if _is_prime(p)]


# 2 p and 4 p fit a block's tiles; 655 = 5 x 131 and 917 = 7 x 131 pass
# a register radix first, 1441 = 11 x 131 a small prime
LARGE_PRIME_SIZES = LARGE_PRIMES + [262, 514, 1018, 2042, 524, 1028, 2036,
                                    1048, 655, 917, 1441]


@pytest.mark.parametrize("n", LARGE_PRIME_SIZES)
def test_large_prime_block_holds_every_pass(n):
    """A plan with a prime past 127 runs on the large instance (256
    threads of 12 values) with the most rows that its values hold, that
    the large-prime pass admits (``_large_pass_fits``, the launcher's
    rule), and whose small prime passes' items fit as before."""
    threads, values = tk.FFT_LARGE_BLOCK
    p = tk._large_prime(n)
    assert p == _largest_prime_factor(n) and tk.k6_route(n) == "fft"

    def fits(rows):
        return (rows * n <= values * threads
                and tk._large_pass_fits(n, p, rows, threads)
                and all(-(-rows * (n // r) // 4) * ((r - 1) // 2)
                        <= values // 8 * threads
                        for r in tk.fft_plan(n)
                        if r not in tk.FFT_REGISTER_RADICES and r < 128))

    assert tk._runtime_block(n) == (threads, max(
        r for r in range(1, values * threads // n + 1) if fits(r)))


def test_planner_constants_are_the_launchers():
    """The planner's mirrors of csrc/spectrum_fft.cu: the primes of the
    two prime passes, the plan's fields, the large pass's outputs a thread
    and its instance, read from the source."""
    src = (Path(tk.__file__).parent.parent / "csrc" / "spectrum_fft.cu") \
        .read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert tk.FFT_SMALL_PRIME_MAX == const("kSmallPrimeMax") == 127
    assert tk.FFT_MAX_PRIME == const("kMaxPrime") == 1021
    assert tk.PLAN_RADIX_BITS == const("kRadixBits")
    assert tk.PLAN_RADICES_A_WORD == const("kRadicesAWord")
    assert tk.LARGE_PASS_OUTPUTS == const("kLpQ")
    assert "static constexpr bool large = VALS_ == %d;" \
        % tk.FFT_LARGE_BLOCK[1] in src
    assert "threads == %d ? (large ? %d : %d)" % (
        tk.FFT_LARGE_BLOCK[0], tk.FFT_LARGE_BLOCK[1],
        tk.FFT_ANY_BLOCKS[0][1]) in src


@pytest.mark.parametrize("n", [4 * 1021, 8 * 509, 16 * 131, 8192 - 40])
def test_large_prime_rows_past_a_block_split(n):
    """Past 256 tiles (4 outputs of one group) a row of a large prime
    fills no block of the large instance; the split route takes it, the
    prime's pass on its rows."""
    assert tk._runtime_block(n) is None and tk.k6_route(n) == "split"
    assert tk._large_prime(n) in tk.k6_split(n)


@pytest.mark.parametrize("p", [131, 257, 509, 1021])
@pytest.mark.parametrize("m", [1, 2])
def test_large_prime_tables_give_the_dft(p, m):
    """The large-prime pass's tables after the n-entry table, n = m p:
    (cos, sin) of 2 pi g^k / p for k < p + 8 (the n-entry table's entries,
    bit for bit, with the sine negated), and r_a = g^a mod p for a < H =
    (p - 1) / 2, one of each pair r, p - r.  In float64 the pass's sums
    in Rader's order, A = y_0 + sum_a s_a c_(a+b) and D = sum_a d_a
    s_(a+b), X_(q_b) = A - j D, X_(p - q_b) = A + j D, give the p-point
    DFT within 1e-6 of max|X| of numpy's (the tables are float32)."""
    n, H = m * p, (p - 1) // 2
    tw = tk._dft_twiddles(n, torch.device("cpu")).numpy()
    tab = tk._core_twiddles(n, torch.device("cpu")).numpy()
    L = p + 2 * tk.LARGE_PASS_OUTPUTS
    assert tab.shape == (n + L + -(-H // 2), 2)
    np.testing.assert_array_equal(tab[:n], tw)
    cs = tab[n:n + L]
    perm = tab[n + L:].copy().view(np.int32).reshape(-1)[:H]
    g = tk._primitive_root(p)
    assert sorted(pow(g, k, p) for k in range(p - 1)) == list(range(1, p))
    np.testing.assert_array_equal(perm, [pow(g, a, p) for a in range(H)])
    assert sorted(set(perm) | {p - r for r in perm}) == list(range(1, p))
    powers = np.array([pow(g, k, p) for k in range(L)])
    np.testing.assert_array_equal(cs[:, 0], tw[powers * m, 0])
    np.testing.assert_array_equal(cs[:, 1], -tw[powers * m, 1])
    # the pass's arithmetic, in float64, on its tables
    y = _cplx(p, (p,)).astype(np.complex128)
    s_ = y[perm] + y[p - perm]
    d_ = y[perm] - y[p - perm]
    c, sn = cs[:, 0].astype(np.float64), cs[:, 1].astype(np.float64)
    k = np.arange(H)[:, None] + np.arange(H)[None, :]           # a + b
    A = y[0] + s_ @ c[k]
    D = d_ @ sn[k]
    X = np.empty(p, np.complex128)
    X[0] = y.sum()
    X[perm] = A - 1j * D
    X[p - perm] = A + 1j * D
    ref = np.fft.fft(y)
    assert np.abs(X - ref).max() <= 1e-6 * np.abs(ref).max()


def _fft_pair(n1, n2):
    """Both factors on the FFT route, neither a power of two past the
    split's pow2 instances."""
    return all(tk.k6_route(f) == "fft"
               and (f & (f - 1) or f <= tk.SPLIT_MAX_POW2) for f in (n1, n2))


@pytest.mark.parametrize("m", range(129, 1025))
def test_k6_split_past_16384_points(m):
    """n = 128 m: (n1, n2) multiply to n, each factor on the FFT route,
    n1 the largest such factor <= sqrt(n) (the most balanced pair), for
    every m: the split route takes every spectrum size past 16384."""
    n = 128 * m
    pair = tk.k6_split(n)
    assert pair is not None
    n1, n2 = pair
    assert n1 * n2 == n and 2 <= n1 <= n2 and _fft_pair(n1, n2)
    assert not any(n % d == 0 and _fft_pair(d, n // d)
                   for d in range(n1 + 1, int(n ** 0.5) + 1))
    assert tk.k6_route(n) == "split"


def test_k6_split_examples():
    assert [tk.k6_split(n) for n in (16512, 32768, 65536, 131072, 16768,
                                     33536, 52608, 127360, 130688,
                                     131968)] \
        == [(128, 129), (128, 256), (256, 256), (256, 512), (128, 131),
            (131, 256), (192, 274), (320, 398), (128, 1021), None]


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


# -- the chirp route ----------------------------------------------------------

def _preferred_lengths(n):
    """m 2^a >= 2 n - 1 for m = 1, 3, 5, each the least of its m,
    ascending."""
    out = []
    for m in tk.CHIRP_LENGTH_ODD:
        M = m
        while M < 2 * n - 1:
            M *= 2
        out.append(M)
    return sorted(out)


def _chirp_takes(M):
    """The chirp route's kernels take M: one block a row or the split,
    and no prime factor past 127 (no large-prime pass)."""
    return _largest_prime_factor(M) <= tk.FFT_SMALL_PRIME_MAX and (
        tk._runtime_block(M) is not None if M <= 16384
        else tk.k6_route(M) == "split")


def test_k6_route_is_chirp_past_a_prime_of_1021():
    """Every n <= 16384 with a prime factor past 1021 (which the direct
    product took before) takes the chirp route, over the least m 2^a >=
    2 n - 1, m = 1, 3, 5, whose transforms the FFT route (M <= 16384) or
    the split (past it) takes, so within 4/3 of 2 n - 1."""
    past = [n for n in range(1031, 16385) if _largest_prime_factor(n) > 1021]
    assert len(past) == 4721
    for n in past:
        M = tk.chirp_length(n)
        assert tk.k6_route(n) == "chirp", n
        assert M == next(L for L in _preferred_lengths(n) if _chirp_takes(L))
        assert 2 * n - 1 <= M < 4 * (2 * n - 1) / 3
        assert tk.k6_route(M) == ("fft" if M <= 16384 else "split")


def test_chirp_route_past_16384_and_where_it_stops():
    """Spectrum sizes 128 x 1031 and 128 x 2053 take the chirp route (M =
    5 x 2^16 = 512 x 640, and 5 x 2^17 = 1024 x 640); the largest M the
    route takes is 3 x 2^24 = 4096 x 12288, so 25165823 is the last n
    it takes, and the n past 25165824 that do not split (2^25 among
    them) stay on the direct product."""
    assert [tk.chirp_length(n) for n in (128 * 1031, 128 * 2053)] == \
        [327680, 655360]
    assert [tk.chirp_split(M) for M in (327680, 655360)] == \
        [(512, 640), (1024, 640)]
    assert all(tk.k6_route(n) == "chirp" for n in (128 * 1031, 128 * 2053))
    assert tk.k6_route(25165823) == "chirp"
    assert tk.chirp_length(25165823) == 3 << 24
    assert tk.chirp_split(3 << 24) == (4096, 12288)
    for n in (25165825, 1 << 25, 1 << 27):
        assert tk.chirp_length(n) is None and tk.k6_route(n) == "direct"


def test_chirp_split_puts_a_power_of_two_on_the_columns():
    """Every m 2^a (m = 1, 3, 5) from 16385 to 2^27: ``chirp_split``
    splits exactly those the split route takes (up to 3 x 2^24, but not
    2^25 = 4096 x 8192), into M1
    a power of two from 128 to 4096 (passes A and A' on the core's pow2
    instances, the only ones the route builds for them) and M2 <= 16384
    on a runtime-plan block (pass B), no power of two past 4096; of the
    pairs that qualify, the one whose larger factor is least."""
    lengths = sorted(m << a for m in tk.CHIRP_LENGTH_ODD for a in range(28)
                     if 16384 < m << a <= 1 << 27)
    assert len(lengths) == 39
    for M in lengths:
        got = tk.chirp_split(M)
        assert (got is not None) == (tk.k6_route(M) == "split") == \
            (M <= 3 << 24 and M != 1 << 25), M
        if got is None:
            continue
        M1, M2 = got
        pairs = [(1 << b, M >> b) for b in range(7, 13)
                 if M % (1 << b) == 0 and M >> b <= 16384
                 and tk._runtime_block(M >> b) is not None
                 and ((M >> b) & ((M >> b) - 1) or M >> b <= 4096)]
        assert M1 * M2 == M and M1 & (M1 - 1) == 0 and 128 <= M1 <= 4096
        assert tk._runtime_block(M2) is not None
        assert max(M1, M2) == min(max(p) for p in pairs)
    assert tk.chirp_split(32768) == (128, 256)
    assert tk.chirp_split(20971520) == (4096, 5120)


def test_chirp_table_within_one_ulp_at_131968():
    """c_t = exp(-j pi t^2 / n), t < n = 131968 = 128 x 1031: the phase
    from t^2 mod 2 n in int64 (t^2 passes int32 from t = 46341), rounded
    once to float32, is within one float32 ulp of a float64 truth; the
    phase from a float32 t^2 is not."""
    n = 131968
    tab = tk._chirp_table(n, torch.device("cpu")).numpy()
    t = np.arange(n)
    ang = np.array([np.pi * (int(v) * int(v) % (2 * n)) / n for v in t])
    truth = np.stack([np.cos(ang), -np.sin(ang)], -1)
    ulp = np.spacing(np.abs(truth).astype(np.float32)).astype(np.float64)
    assert (np.abs(tab - truth) <= ulp).all()
    t32 = t.astype(np.float32)
    ang32 = np.float32(np.pi) * (t32 * t32) / np.float32(n)
    wrong = np.stack([np.cos(ang32.astype(np.float64)),
                      -np.sin(ang32.astype(np.float64))], -1)
    assert np.abs(wrong - truth).max() > 1e-2


@pytest.mark.parametrize("n", [1031, 2062, 16381, 131968])
def test_chirp_passes_match_numpy(n):
    """``chirp_fft_plain``: the chirp, the forward transform over M (one
    row of 2560 and 5120 points; the split's passes over 128 x 256 and
    512 x 640), the product with D, the second transform and the final
    chirp, in complex128 on the float32 tables: 1e-5 of max|X|."""
    x = _cplx(n, (2, n))
    got = tk.chirp_fft_plain(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and got.dtype == np.complex64
    assert _rel(got, np.fft.fft(x.astype(np.complex128))) <= REL


# -- the passes against numpy and JAX ----------------------------------------

@pytest.mark.parametrize("n", PLAN_SIZES + [131, 262, 1021])
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
                                   (128, 129), (128, 131), (131, 256)])
def test_split_passes_match_numpy(n1, n2):
    """The split route's passes at forced splits: a power of two on
    either side, a register radix (3) and a runtime plan (129 = 3 x 43,
    a direct 43-point pass), and a large prime on either side (16768 =
    128 x 131 and 33536 = 131 x 256, the splits k6_split gives)."""
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
    (12288, 2), (16256, 2), (16384, 2), (131, 4), (1021, 3), (2042, 2)])
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


@pytest.mark.parametrize("n,tile_k", [(131, 131), (262, 131), (1021, 1021)])
def test_large_prime_steps_match_jax_spectrum_fused(n, tile_k):
    """K6's epilogue on the passes at a prime past 127 (131 alone, 2 x
    131, 1021) against JAX's ``spectrum_fused`` in interpret mode, its
    bin tile a divisor of n: 2e-4, the bar above."""
    j, t = _pair(n, 8)
    iq = _input(n, 8, seed=n)
    ref = np.asarray(jk.spectrum_fused(
        jnp.asarray(iq), np.asarray(j._win), float(j._coeff),
        float(j._scale), float(j._offset), tile_k=tile_k, interpret=True))
    got = _steps(iq, t)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 2e-4
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()
    assert (got[ZERO_ROW] == 0.0).all()


def test_k6_wrapper_on_cpu_runs_plain_and_counts_no_route():
    _, t = _pair(384, 2)
    iq = torch.from_numpy(_input(384, 2, seed=1))
    args = (t._win, t._coeff, t._scale, t._offset)
    before = (tk.spectrum_fused.launches, dict(tk.spectrum_fused.routes))
    got = tk.spectrum_fused(iq, *args)
    assert torch.equal(got, tk.spectrum_fused_plain(iq, *args))
    assert (tk.spectrum_fused.launches, tk.spectrum_fused.routes) == before
    assert set(tk.spectrum_fused.routes) == {"fft", "split", "chirp",
                                             "direct"}
