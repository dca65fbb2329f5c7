"""The card-floor probes' kernels in the port against the JAX probes'
Pallas bodies, on the CPU: K13 ``scale_copy``, K14 ``staged_copy`` and
K15 ``tile_dot`` (``cyberether_tpu_torch/ops/probe_kernels.py``), whose
wrappers run their plain versions on CPU tensors.

The JAX bodies run in interpret mode.  ``stream_probe.py`` is imported
(its measurements run only as a script); ``platform_probe.py`` and
``f16_probe.py`` measure at import, so ``k_copy``, ``k_dot`` and ``kern``
are taken from the file with ``ast`` and compiled alone.  The manual DMA
copy runs with ``interpret=True``, which performs each DMA at its start:
its slot reuse is a race under an interpreter that performs DMAs at
their wait, which the port does not carry over.

Tolerances, and why:
- K13 and K14: exact (a scale by 1 or 2 and a copy);
- K15 "fp32": 1e-6 of max|o| against JAX's float32 dot (both sum 128
  float32 products; the plain version in float64);
- "tf32": 2e-3 of max|o| against a float64 truth of the unrounded
  inputs (TF32 keeps 10 mantissa bits), and more than 1e-5 from it (a
  product that skipped the rounding would be closer); "3xtf32": 1e-5
  (the hi/lo split keeps ~21);
- "bf16" and "f16": 1e-5 of max|o| against the float64 product of the
  same inputs, ``f16_probe``'s own measure, and against JAX's body.
"""

import ast
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cyberether_tpu_torch.ops import probe_kernels as pk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ABLATION = ROOT / "tools" / "ablation"
M, W = 64, 128
TILE = 16


def _body(file: str, name: str):
    """The function ``name`` of ``tools/ablation/<file>``, compiled alone
    from the file's source (the file itself measures at import)."""
    tree = ast.parse((ABLATION / file).read_text(), filename=file)
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    namespace = {"jnp": jnp, "jax": jax, "pl": pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=[node], type_ignores=[]), file, "exec"),
         namespace)
    return namespace[name]


@pytest.fixture(scope="module")
def stream_probe():
    """``tools/ablation/stream_probe.py`` imported, sys.path as it was."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "ablation_stream_probe", ABLATION / "stream_probe.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def _rows(seed: int, rows: int = M, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, W)).astype(
        dtype)


def _tiled(kernel, x, *others, out_dtype=jnp.float32):
    """``kernel`` over row tiles of x, the TPU probes' grid, in interpret
    mode; each of ``others`` a whole (128, 128) block."""
    rows = x.shape[0]
    return np.asarray(pl.pallas_call(
        kernel, grid=(rows // TILE,),
        in_specs=[pl.BlockSpec((TILE, W), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)] + [
            pl.BlockSpec((W, W), lambda i: (0, 0), memory_space=pltpu.VMEM)
            for _ in others],
        out_specs=pl.BlockSpec((TILE, W), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, W), out_dtype),
        interpret=True)(jnp.asarray(x), *map(jnp.asarray, others)))


# -- K13 scale_copy ------------------------------------------------------------

def test_k13_matches_platform_probe_k_copy():
    x = _rows(0)
    ref = _tiled(_body("platform_probe.py", "k_copy"), x)
    got = pk.scale_copy(torch.from_numpy(x), 2.0)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k13_matches_stream_probe_copy_kernel(stream_probe):
    x = _rows(1)
    ref = _tiled(stream_probe.copy_kernel, x)
    got = pk.scale_copy(torch.from_numpy(x), 1.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("rows,rows_per_block", [(1, 1), (37, 16),
                                                 (64, 2048)])
def test_k13_takes_any_rows(rows, rows_per_block):
    x = torch.from_numpy(_rows(2, rows))
    assert torch.equal(pk.scale_copy(x, 2.0, rows_per_block), x * 2.0)


# -- K14 staged_copy -----------------------------------------------------------

@pytest.mark.parametrize("chunks", [2, 4, 8])
def test_k14_matches_stream_probe_manual_kernel(stream_probe, chunks):
    chunk = M // chunks
    x = _rows(3)
    ref = np.asarray(pl.pallas_call(
        functools.partial(stream_probe.manual_kernel, chunk=chunk, n=chunks),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((M, W), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, chunk, W), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,)),
                        pltpu.SemaphoreType.DMA((2,))],
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True)(jnp.asarray(x)))
    np.testing.assert_array_equal(ref, x)
    got = pk.staged_copy(torch.from_numpy(x), stage_bytes=chunk * W * 4)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rows,stage_bytes", [(1, 16), (3, 4096),
                                              (64, 65536)])
def test_k14_takes_any_rows_and_one_chunk(rows, stage_bytes):
    """Any size, a single chunk included: JAX's epilogue needs two."""
    x = torch.from_numpy(_rows(4, rows))
    got = pk.staged_copy(x, stage_bytes)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("stage_bytes", [0, 24, pk.K14_MAX_STAGE_BYTES + 16])
def test_k14_rejects_stage_sizes_it_does_not_take(stage_bytes):
    with pytest.raises(ValueError, match="stage_bytes"):
        pk.staged_copy(torch.zeros((4, W)), stage_bytes)


# -- K15 tile_dot --------------------------------------------------------------

def _truth(x: np.ndarray, b: np.ndarray) -> np.ndarray:
    return x.astype(np.float64) @ b.astype(np.float64)


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - ref).max()
                 / np.abs(ref).max())


def test_k15_fp32_matches_platform_probe_k_dot():
    x, b = _rows(5), _rows(6, W)
    ref = _tiled(_body("platform_probe.py", "k_dot"), x, b)
    got = pk.tile_dot(torch.from_numpy(x), torch.from_numpy(b), "fp32")
    assert got.dtype == torch.float32 and got.shape == (M, W)
    assert _rel(got.numpy(), ref.astype(np.float64)) <= 1e-6
    assert _rel(got.numpy(), _truth(x, b)) <= 1e-6


@pytest.mark.parametrize("mode,tol", [("tf32", 2e-3), ("3xtf32", 1e-5)])
def test_k15_tf32_modes_against_float64_truth(mode, tol):
    x, b = _rows(7), _rows(8, W)
    got = pk.tile_dot(torch.from_numpy(x), torch.from_numpy(b), mode)
    err = _rel(got.numpy(), _truth(x, b))
    assert err <= tol
    if mode == "tf32":
        assert err > 1e-5          # the inputs were rounded to TF32


def test_k15_3xtf32_is_closer_than_tf32():
    x, b = _rows(9), _rows(10, W)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    one = _rel(pk.tile_dot(tx, tb, "tf32").numpy(), _truth(x, b))
    three = _rel(pk.tile_dot(tx, tb, "3xtf32").numpy(), _truth(x, b))
    assert three < one / 100


def test_k15_f16_meets_f16_probe_measure():
    """f16_probe's inputs and measure: max |o - o64| / max |o64|."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 128)).astype(np.float16)
    b = rng.standard_normal((128, 128)).astype(np.float16)
    ref = _truth(a, b)
    jax_out = np.asarray(pl.pallas_call(
        _body("f16_probe.py", "kern"),
        out_shape=jax.ShapeDtypeStruct((256, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))
    got = pk.tile_dot(torch.from_numpy(a), torch.from_numpy(b), "f16")
    assert _rel(jax_out, ref) <= 1e-5
    assert _rel(got.numpy(), ref) <= 1e-5
    assert _rel(got.numpy(), jax_out.astype(np.float64)) <= 1e-5


def test_k15_bf16_matches_k_dot_on_bf16_inputs():
    x = torch.from_numpy(_rows(11)).to(torch.bfloat16)
    b = torch.from_numpy(_rows(12, W)).to(torch.bfloat16)
    xn, bn = x.float().numpy(), b.float().numpy()
    ref = _tiled(_body("platform_probe.py", "k_dot"),
                 jnp.asarray(xn, jnp.bfloat16), jnp.asarray(bn, jnp.bfloat16))
    got = pk.tile_dot(x, b, "bf16").numpy()
    assert _rel(got, _truth(xn, bn)) <= 1e-5
    assert _rel(got, ref.astype(np.float64)) <= 1e-5


def test_tf32_round_is_cvt_rna():
    """Nearest, ties away from zero, to 10 mantissa bits."""
    bits = np.array([0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F801001,
                     0xBF801000, 0xBF800FFF, 0x3F803000, 0x00001000],
                    np.uint32)
    want = np.array([0x3F800000, 0x3F802000, 0x3F800000, 0x3F802000,
                     0xBF802000, 0xBF800000, 0x3F804000, 0x00002000],
                    np.uint32)
    got = pk.tf32_round(torch.from_numpy(bits.view(np.float32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    x = _rows(13)
    r = pk.tf32_round(torch.from_numpy(x)).numpy()
    assert not (r.view(np.uint32) & 0x1FFF).any()
    ulp = np.spacing(np.abs(x)) * 2.0 ** 13
    assert (np.abs(r - x) <= ulp / 2).all()


def test_3xtf32_split_is_exact_to_21_bits():
    x = torch.from_numpy(_rows(14))
    hi = pk.tf32_round(x)
    lo = pk.tf32_round(x - hi)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -21).all())


@pytest.mark.parametrize("mode", list(pk.TILE_DOT_MODES))
def test_k15_takes_ragged_rows(mode):
    dtype = pk.TILE_DOT_MODES[mode][1]
    x = torch.from_numpy(_rows(15, 37)).to(dtype)
    b = torch.from_numpy(_rows(16, W)).to(dtype)
    want = pk.tile_dot_plain(x, b, mode)
    assert torch.equal(pk.tile_dot(x, b, mode, rows_per_block=64), want)
    assert want.shape == (37, W) and want.dtype == torch.float32


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 129])
@pytest.mark.parametrize("mode", list(pk.TILE_DOT_MODES))
def test_k15_cpu_route_at_tile_edges(mode, rows):
    """The CPU route at rows that leave the kernel's 64-row tile ragged,
    fill it or pass it by one: (rows, 128) float32 within the mode's bar
    of the float64 product of its inputs (tf32 2e-3, the rest 1e-5)."""
    dtype = pk.TILE_DOT_MODES[mode][1]
    x = torch.from_numpy(_rows(17, rows)).to(dtype)
    b = torch.from_numpy(_rows(18, W)).to(dtype)
    got = pk.tile_dot(x, b, mode, rows_per_block=64)
    assert got.shape == (rows, W) and got.dtype == torch.float32
    truth = _truth(x.float().numpy(), b.float().numpy())
    assert _rel(got.numpy(), truth) <= (2e-3 if mode == "tf32" else 1e-5)


def test_k15_rejects_what_it_does_not_take():
    x, b = torch.zeros((64, W)), torch.zeros((W, W))
    with pytest.raises(ValueError, match="mode"):
        pk.tile_dot(x, b, "fp64")
    with pytest.raises(ValueError, match="rows_per_block"):
        pk.tile_dot(x, b, "fp32", rows_per_block=100)
    with pytest.raises(ValueError, match="bfloat16"):
        pk.tile_dot(x, b, "bf16")
    with pytest.raises(ValueError, match="b must be"):
        pk.tile_dot(x, torch.zeros((W, 64)), "fp32")
