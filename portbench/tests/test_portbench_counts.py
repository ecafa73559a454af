"""The counts of operations and bytes, worked by hand at 3 qubits."""

from portbench import harness, yardstick as ys


def test_hea_ops_at_three_qubits():
    counts = harness.load(harness.HERE / 'counts' / 'hea26.py', 'c_hea')
    cfg = {'nqubit': 3, 'layers': 1, 'rotations': ['rx', 'rz', 'rx']}
    # per amplitude: 3 x (rx 16 + rz 6 + rx 16) + 3 CNOTs 0 + X string 0 + inner product 8
    assert counts.forward_ops(cfg) == (3 * 38 + 8) * 8
    assert counts.ops_per_call(cfg, {'loop': 'train'}) == 3 * 122 * 8
    assert counts.ops_per_call(cfg, {'loop': 'eval'}) == 122 * 8


def test_gate_kernels_at_three_qubits():
    amps = 8
    assert ys.gate_kernel_cost('planar_apply', (2, 0), amps) == (128, 256, ys.PEAK_FP32_S)
    assert ys.gate_kernel_cost('planar_grad', (1, 1, 1), amps) == (128, 128, ys.PEAK_FP32_S)
    assert ys.gate_kernel_cost('planar_bwd_fused', (1, 0), amps) == (256, 384, ys.PEAK_FP32_S)
    assert ys.gate_kernel_cost('window_apply', (), amps) == (128, 8192, ys.PEAK_FP64_TC_S)
    assert ys.gate_kernel_cost('window_chain_fwd', (), amps) is None
    assert ys.least_s(128, 8192, ys.PEAK_FP64_TC_S) == 8192 / 67e12
    assert ys.least_s(256, 384) == 256 / 3.35e12


def test_kernel_names_from_the_trace():
    name = ('void (anonymous namespace)::planar_apply_kernel<3, 1>(float*, float const*, '
            'float const*, unsigned int, unsigned int, unsigned int, int, int, int, int, int)')
    assert ys.port_kernel(name) == ('planar_apply', (3, 1))
    assert ys.port_kernel('void (anonymous namespace)::chain_bwd_kernel(int const*)') == \
        ('chain_bwd', ())
    assert ys.port_kernel('void at::native::elementwise_kernel<128, 2>(int)') is None
