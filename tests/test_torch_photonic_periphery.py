"""PyTorch port vs the JAX package: the photonic periphery, on the CPU at
complex128. The SVG drawing of a circuit (character for character, the
JAX text for the same circuit), the Clements plot (written to a file), the
Reck decompositions 'rssr' / 'rssl' (the same MZI angles and phases,
1e-10, and the unitary rebuilt from them), the unitary mapper's transfer
matrix (the same numbers on the same matrix) and its single-qubit solve
with the cache in a temporary folder, and the sample files and chunk-size
knobs of ``photonic/utils.py``.
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.photonic import decompose as jdec
from deepquantum_tpu.photonic import mapper as jmap
from deepquantum_tpu_torch.photonic import decompose as tdec
from deepquantum_tpu_torch.photonic import mapper as tmap

torch.set_num_threads(1)
ATOL = 1e-10


@pytest.fixture(autouse=True)
def _cpu_c128():
    """The port's default device is the card and its default dtype
    complex64: these tests ask for the CPU and complex128."""
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


def _haar(k, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _draw_build(cir):
    cir.s(0, r=0.4)
    cir.bs([0, 1], inputs=[0.5, 0.1])
    cir.ps(2, inputs=0.7)
    cir.d(1, r=0.2, theta=0.3)
    cir.barrier()
    cir.mzi([1, 2], inputs=[0.2, 0.9])
    cir.any(_haar(2, 0), [0, 2])
    cir.homodyne_x(2)


def test_draw_svg_equals_jax(tmp_path):
    """tests/test_periphery.py::test_photonic_draw_svg on a wider circuit:
    the port's SVG text is the JAX package's, and the file is written."""
    jc = dq.photonic.QumodeCircuit(nmode=3, init_state='vac', cutoff=3, backend='gaussian')
    tc = dqt.QumodeCircuit(3, init_state='vac', cutoff=3, backend='gaussian')
    for c in (jc, tc):
        _draw_build(c)
    svg = tc.draw(filename=str(tmp_path / 'c.svg'))
    assert svg.startswith('<svg') and (tmp_path / 'c.svg').read_text() == svg
    assert svg == jc.draw()
    tdm = dqt.QumodeCircuit(1, init_state='vac', cutoff=3, backend='gaussian')
    jtdm = dq.photonic.QumodeCircuit(1, init_state='vac', cutoff=3, backend='gaussian')
    for c in (tdm, jtdm):
        c.s(0, r=0.3)
        c.delay(0, ntau=2, inputs=[0.4, 0.5])
        c.loss(0, inputs=[0.2])
    assert tdm.draw() == jtdm.draw()
    # the JAX package draws the unrolled TDM circuit only once it has been
    # unrolled (its draw reads the list without making it); the port makes it
    jtdm._prepare_unroll_dict()
    jtdm._unroll_circuit()
    assert tdm.draw(unroll=True) == jtdm.draw(unroll=True)


def test_draw_clements_plot(tmp_path):
    from deepquantum_tpu_torch.photonic.draw import DrawClements
    dec = tdec.UnitaryDecomposer(_haar(4, 1))
    fig = DrawClements(4, dec.decomp()).plot(str(tmp_path / 'mesh.png'))
    assert (tmp_path / 'mesh.png').stat().st_size > 0 and fig is not None


@pytest.mark.parametrize('method', ['rssr', 'rssl', 'cssr'])
def test_decomposer_matches_jax(method):
    u = _haar(5, 2)
    info, dic_mzi, dic_pos = tdec.UnitaryDecomposer(u, method).decomp()
    jinfo, jmzi, jpos = jdec.UnitaryDecomposer(u, method).decomp()
    np.testing.assert_allclose(np.asarray(info['MZI_list']), np.asarray(jinfo['MZI_list']),
                               atol=ATOL)
    np.testing.assert_allclose(info['phase_angle'], jinfo['phase_angle'], atol=ATOL)
    assert dic_mzi.keys() == jmzi.keys()
    for key in jmzi:
        np.testing.assert_allclose(np.asarray(dic_mzi[key]), np.asarray(jmzi[key]), atol=ATOL)
    assert (dic_pos is None) == (method != 'cssr')
    if method == 'cssr':
        assert dic_pos == jpos
        return
    # rebuild: rssr eliminated U T_1 ... T_m = D, rssl T_m ... T_1 U = D
    n = len(u)
    kind = 'inv_r' if method == 'rssr' else 'inv_l'
    factors = [tdec._mzi_embed(n, jj, ii, phi, theta, kind)
               for jj, ii, phi, theta in info['MZI_list']]
    d = np.diag(np.exp(1j * info['phase_angle']))
    rebuilt = d
    if method == 'rssr':
        for t in reversed(factors):
            rebuilt = rebuilt @ t.conj().T
    else:
        for t in reversed(factors):
            rebuilt = t.conj().T @ rebuilt
    np.testing.assert_allclose(rebuilt, u, atol=1e-10)


def test_decomposer_method_check():
    with pytest.raises(ValueError, match='method'):
        tdec.UnitaryDecomposer(np.eye(2), 'xyz')


def test_mapper_transfer_matrix_and_single_qubit_solve(tmp_path, monkeypatch):
    """The transfer matrix of a random 6-mode matrix under the CNOT
    mapper's basis (two ancillas) equals the JAX mapper's; the Hadamard
    solve of tests/test_periphery.py::test_unitary_mapper_single_qubit
    finds a unitary whose transfer matrix is |H|, and writes its cache
    only under DQ_MAPPER_CACHE."""
    monkeypatch.setenv('DQ_MAPPER_CACHE', str(tmp_path))
    cnot = np.eye(4)[[0, 1, 3, 2]]
    kw = dict(nqubit=2, nmode=6, ugate=cnot, success=1 / 3, aux=[0, 0], aux_pos=[4, 5])
    u = _haar(6, 3)
    np.testing.assert_allclose(tmap.UnitaryMapper(**kw).get_transfer_mat(u),
                               jmap.UnitaryMapper(**kw).get_transfer_mat(u), atol=ATOL)
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    mapper = tmap.UnitaryMapper(nqubit=1, nmode=2, ugate=h, success=1.0)
    sols = mapper.solve_eqs_real(total_trials=5)
    assert sols and mapper.is_unitary(sols[0])
    np.testing.assert_allclose(np.abs(mapper.get_transfer_mat(sols[0])), np.abs(h), atol=1e-5)
    assert len(list(tmp_path.glob('*.npz'))) == 1
    assert len(mapper.solve_eqs_real(total_trials=5)) == len(sols)        # from the cache


def test_samples_and_chunk_sizes(tmp_path):
    from deepquantum_tpu_torch.photonic import qmath as tq
    from deepquantum_tpu_torch.photonic import utils as tu
    sample = {dqt.FockState([1, 0, 1]): 7, dqt.FockState([0, 2, 0]): 3}
    tu.save_sample(sample, str(tmp_path / 's.pkl'))
    assert tu.load_sample(str(tmp_path / 's.pkl')) == {repr(k): v for k, v in sample.items()}
    from deepquantum_tpu.photonic import utils as ju
    ju.save_sample(sample, str(tmp_path / 'j.pkl'))
    assert tu.load_sample(str(tmp_path / 'j.pkl')) == ju.load_sample(str(tmp_path / 'j.pkl'))
    assert tu.mem_to_chunksize('cuda', 'c64') == 1 << 16
    tu.set_perm_chunksize('cuda', 'c64', 1 << 10)
    assert tu.mem_to_chunksize('cuda', 'c64') == 1 << 10
    tu._PERM_CHUNKSIZE.clear()
    assert tu.set_hbar is dqt.set_hbar and tu.set_kappa is dqt.set_kappa
    mats = torch.as_tensor(np.stack([_haar(5, s) for s in range(3)]))
    want = tq.permanent_batch(mats)
    tq.set_perm_chunksize(5, 3)
    try:
        assert tq.perm_chunksize_dict[5] == 3
        np.testing.assert_allclose(tq.permanent_batch(mats).numpy(), want.numpy(), atol=ATOL)
    finally:
        tq.perm_chunksize_dict.clear()
