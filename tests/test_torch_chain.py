"""PyTorch port vs the JAX package: the window-chain twin.

The sequence is the bench ansatz's scheduled forward at n=16 (windows and
relabels only). The JAX one-launch kernel runs in interpret mode; it emits
hand-split bf16 x6 products (about float32 accuracy, terms below 2^-24
dropped), so over 29 windows the two agree to 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.ops import chain_kernel as jck
from deepquantum_tpu_torch.ops import chain_kernel as tck

from test_torch_window import bench, jax_planar_seq

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    dqt.set_device('cpu')
    yield
    dqt.set_device(None)


@pytest.fixture()
def c64():
    dq.set_dtype('complex64')
    dqt.set_dtype('complex64')
    os.environ['DQ_PLANAR'] = '1'
    yield
    os.environ.pop('DQ_PLANAR', None)
    dq.set_dtype('complex128')


def _seq(n, layers=1):
    cir = dqt.from_jax(bench(n, layers))
    with torch.inference_mode():
        return cir._planar_seq(cir._full_params())


def test_chain_twin_matches_jax_kernel(c64):
    n = 16
    jres, jims, jseq = jax_planar_seq(bench(n, layers=1))
    assert jck.chain_fused_ok(jseq, n, jres)
    tres, tims, tseq = _seq(n)
    assert tck.chain_fused_ok(tseq, n, tres)
    x = np.random.default_rng(16).standard_normal((2, 1 << n)).astype(np.float32)
    want = np.asarray(jck.window_chain_fwd(jnp.asarray(x), jres, jims, n, jseq, interpret=True))
    xt = torch.as_tensor(x)
    got = tck.window_chain_fwd(xt, tres, tims, n, tseq)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(xt.numpy(), x)   # the caller's state is not written
    np.testing.assert_array_equal(tck.window_chain_plain(xt, tres, tims, n, tseq).numpy(),
                                  got.numpy())


@pytest.mark.parametrize('n,ok', [(13, False), (14, False), (16, True), (18, True),
                                  (20, False)])
def test_chain_fused_ok_matches_jax(n, ok, c64):
    jres, _, jseq = jax_planar_seq(bench(n, layers=1))
    tres, _, tseq = _seq(n)
    assert tck.chain_fused_ok(tseq, n, tres) == jck.chain_fused_ok(jseq, n, jres) == ok


def test_step_table():
    seq = [('win', 7), ('rot', 9), ('win', 7), ('rot', 7), ('win', 7)]
    rows, win_steps = tck._step_table(seq, 16)
    assert rows == [(1, 0, 0), (0, 9, 0), (1, 0, 1), (0, 7, 0), (1, 0, 2)]
    assert win_steps == [0, 2, 4]
