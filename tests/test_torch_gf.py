"""The port's GF(2^8) oracle, coding matrices and bit-plane torch ops
(ceph_tpu_torch.ops.gf, .ec.matrices, .ops.gf_bitplane) against the JAX
package's twins on the same seeded numpy inputs. Every comparison is
bit-exact (tolerance 0): the data are integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.ec import matrices as jmat
from ceph_tpu.ops import gf as jgf
from ceph_tpu.ops import gf_bitplane as jbp
from ceph_tpu_torch.ec import matrices as tmat
from ceph_tpu_torch.ops import gf as tgf
from ceph_tpu_torch.ops import gf_bitplane as tbp
from ceph_tpu_torch.ops import gf_cuda as gc


def test_field_tables_identical():
    assert np.array_equal(tgf.GF_EXP, jgf.GF_EXP)
    assert np.array_equal(tgf.GF_LOG, jgf.GF_LOG)
    assert tgf.GF_POLY == jgf.GF_POLY


@pytest.mark.parametrize("r,n,c", [(3, 8, 16), (4, 5, 7), (1, 12, 33)])
def test_oracle_products_match(r, n, c):
    rng = np.random.default_rng(r * 100 + n)
    a = rng.integers(0, 256, (r, n), np.uint8)
    b = rng.integers(0, 256, (n, c), np.uint8)
    assert np.array_equal(tgf.gf_matmul(a, b), jgf.gf_matmul(a, b))
    assert np.array_equal(tgf.gf_region_matmul(a, b), jgf.gf_region_matmul(a, b))
    assert np.array_equal(tgf.gf_region_matmul(a, b), tgf.gf_matmul(a, b))
    assert np.array_equal(tgf.matrix_to_bitmatrix(a), jgf.matrix_to_bitmatrix(a))
    assert np.array_equal(tgf.gf_matmul_via_bits(a, b), jgf.gf_matmul_via_bits(a, b))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_invert_matrix_matches(n):
    gen = jmat.generator_matrix("isa_cauchy", n, 3)
    sub = gen[1: n + 1]
    inv = tgf.gf_invert_matrix(sub)
    assert np.array_equal(inv, jgf.gf_invert_matrix(sub))
    assert np.array_equal(tgf.gf_matmul(inv, sub), np.eye(n, dtype=np.uint8))


@pytest.mark.parametrize("technique", sorted(jmat.TECHNIQUES))
@pytest.mark.parametrize("k,m", [(2, 2), (4, 2), (8, 3), (7, 3)])
def test_coding_matrices_match(technique, k, m):
    if technique == "reed_sol_r6_op" and m != 2:
        pytest.raises(ValueError, tmat.build_parity_matrix, technique, k, m)
        return
    want = jmat.generator_matrix(technique, k, m)
    got = tmat.generator_matrix(technique, k, m)
    assert np.array_equal(got, want)
    present = list(range(m, k + m))
    targets = list(range(m))
    assert np.array_equal(
        tmat.decode_matrix(got, k, present, targets),
        jmat.decode_matrix(want, k, present, targets),
    )


def test_bitplane_matrix_matches():
    mat = np.random.default_rng(1).integers(0, 256, (3, 5), np.uint8)
    got = tbp.bitplane_matrix(mat, device="cpu")
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(jbp.bitplane_matrix(mat)))


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 40)])
def test_unpack_pack_bits_match(shape):
    x = np.random.default_rng(2).integers(0, 256, shape, np.uint8)
    bits = tbp.unpack_bits(torch.from_numpy(x))
    assert np.array_equal(bits.numpy(), np.asarray(jbp.unpack_bits(jnp.asarray(x))))
    assert np.array_equal(tbp.pack_bits(bits).numpy(), x)
    assert np.array_equal(
        tbp.pack_bits(bits).numpy(),
        np.asarray(jbp.pack_bits(jnp.asarray(bits.numpy()))),
    )


@pytest.mark.parametrize("batch,k,r,length", [(1, 4, 2, 64), (3, 8, 3, 100), (2, 6, 4, 7)])
def test_gf_matmul_bitplane_matches(batch, k, r, length):
    rng = np.random.default_rng(batch * 10 + k)
    mat = rng.integers(0, 256, (r, k), np.uint8)
    data = rng.integers(0, 256, (batch, k, length), np.uint8)
    bits = tbp.bitplane_matrix(mat, device="cpu")
    got = tbp.gf_matmul_bitplane(
        bits, torch.from_numpy(data), tables=torch.from_numpy(gc.kernel_tables(bits.numpy()))
    )
    want = jbp.gf_matmul_bitplane(jbp.bitplane_matrix(mat), jnp.asarray(data))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))
    for b in range(batch):
        assert np.array_equal(got[b].numpy(), tgf.gf_matmul(mat, data[b]))


def test_gf_matmul_bitplane_rejects_bad_shapes():
    mat = tbp.bitplane_matrix(np.ones((2, 4), np.uint8), device="cpu")
    tables = torch.from_numpy(gc.kernel_tables(mat.numpy()))
    with pytest.raises(ValueError):
        tbp.gf_matmul_bitplane(mat, torch.zeros((1, 3, 8), dtype=torch.uint8), tables=tables)
    with pytest.raises(TypeError):
        tbp.gf_matmul_bitplane(mat, torch.zeros((1, 4, 8), dtype=torch.int32), tables=tables)


def test_xor_reduce_matches():
    data = np.random.default_rng(3).integers(0, 256, (2, 5, 48), np.uint8)
    got = tbp.xor_reduce(torch.from_numpy(data))
    assert got.shape == (2, 1, 48)
    assert np.array_equal(got.numpy(), np.asarray(jbp.xor_reduce(jnp.asarray(data))))
