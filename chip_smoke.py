#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile [--out FILE]   # where a grad step's, a batched
                                                   # QML step's and a photonic
                                                   # call's time goes

Phases (each raises on failure, so the run exits non-zero):

1. require CUDA; print the card (nvidia-smi name and power limit), torch and
   CUDA versions;
2. build the CUDA kernels from deepquantum_tpu_torch/csrc and print the
   build time and each kernel's ptxas registers and spills (a spill in
   any instance of planar_apply, planar_grad or planar_bwd_fused fails the
   run; K7's instances again on one line);
3. hold each of the nine kernels against its plain PyTorch twin on the card
   (K1-K6: float32, unnormalised randn states from a fixed seed; state error =
   max|d| / max|ref| of the state outputs, plane error the same for the
   reduced cotangent planes), with CUDA-event median times and the least
   time the card could take (bound_ms, from the bytes each call must move
   and the operations it does, against the published peaks):
   planar_apply, planar_grad, planar_bwd_fused at n=22 on eight wire sets
   (states <= 1e-6 / 1e-5, planes <= 1e-5; planar_apply and planar_grad, and
   their batched forms below, also timed against the one torch.einsum that
   computes the same, held to 1e-5 of the twin; all three with their device
   time (CUDA events behind a queued sleep kernel) beside the time through
   the wrapper, at n=22 also with the L2 flushed before each call;
   planar_grad's and planar_bwd_fused's dW bitwise equal over two launches,
   and a profiler window of five calls issuing five device operations (host
   launch calls; the device's records all the kernel's own), at n=22 and at
   n=14, B=100: the sum over blocks ends inside the launch; the float32 twin of planar_grad <= 1e-6 of its float64
   run at n=18, B=8 on amplitude bit 0), window_apply at n=24 with a
   random unitary (<= 1e-6; also timed against the one library call that
   computes the same function, a real 256 x 256 block matmul) and at
   n = 12, 13, 16, 20, 24 with a random non-unitary W (<= 1e-6),
   window_chain_fwd and window_chain_bwd at n=18 on the bench ansatz's
   scheduled sequence (states <= 1e-5, dW <= 1e-5; both also at n = 14 and
   19, and at n=19 on a grid of 114 SMs where a block walks two column
   tiles; window_chain_bwd's dW bitwise equal over two launches; both with
   their device time alone from torch.profiler beside the time through the
   wrapper). window_apply, window_chain_fwd and window_chain_bwd run their
   products on the FP64 tensor cores (csrc/window_mma.cuh): their bound_ms
   is that route's (67 TFLOP/s); the 3xTF32 bound and the chains' barrier
   counts from their step tables go on a line of their own, as derived
   numbers. K7-K9 compute in float64 and are bounded against the FP64
   rate: permanent_cuda_batch on Haar unitaries at (B, n) =
   (12376, 6), (3, 4), (2, 5), (1000, 14) (<= 1e-10 of the twin, and of a
   numpy Ryser of its own), (1, 20), (4, 20), (1, 22) (<= 1e-8: the terms
   cancel by 1e4 to 1e5; at n=20 also against a long-double numpy Ryser),
   and n=26 once for time and a finite value; each bitwise equal over two
   launches, with its device time beside the wrapper's, and one device
   operation a call at (12376, 6) and (1, 20); tor_dets_cuda and tor_dets_quads_cuda at
   m = 8, 10, 12, 14 on O = I - (I + M M^T)^-1 and on O plus a non-symmetric
   perturbation (per-subset det and quad <= 1e-9 of the twin, the
   torontonian <= 1e-6, or 1e-15 times its cancellation where that is
   more), tor_dets_cuda also timed against torch.linalg.det
   on the pre-gathered stacks; their batched forms (rows
   tor_dets_cuda_batched, tor_dets_quads_cuda_batched: one wrapper call on a
   (B, 2m, 2m) stack) at path (b)'s own stacks, the k-click sub-matrices of
   10- and 14-mode GBS states, (B, m) = (1001, 10) at 14 modes and (120, 3),
   (252, 5), (45, 8), (1, 10) at 10 modes, against the batched twins (per
   subset <= 1e-9, each torontonian at the bar above), with the device time
   (CUDA events behind a queued sleep kernel) beside the time through the
   wrapper. The batched
   forms of K1, K5, K6 (rows planar_apply_batched, planar_grad_batched,
   planar_bwd_fused_batched) on (B, 2, 2^n) stacks with per-sample planes at (n, B) = (14, 100),
   (20, 8) and (18, 8) (the wide QML path's: gates on amplitude bit 0, bits
   0-1 and the top bit), k = 1, 2, 3 (states <= 1e-6, K6 1e-5, planes
   <= 1e-5), with device times, K1 also
   with one set of planes for every sample. The batched gate chain (rows
   planar_chain_batched, planar_chain_batched_bwd: K1b / K6b redesigned, a
   whole chain in one launch per direction, csrc/planar_chain_batched.cu) at
   (n, B) = (14, 100), (12, 256), (16, 8) on the QML ansatz's sequence with
   Haar planes (check_batched_chain): against the twin and the per-step
   K1b / K5b / K6b, states <= 1e-6 (backward 1e-5), planes <= 1e-5, dW
   bitwise equal over two launches, device time beside the wrapper's, the
   bound, the per-step route's time and the cluster sizes. The window kernels under
   depth (check_window_depth): the bench sequence at n=18 with 10 and 20
   layers, walked by window_chain_fwd, by window_apply window by window
   with the twin's relabels, and backward by window_chain_bwd; states
   <= 1e-5 of the float32 twin, dW <= 1e-5, and against the twin run in
   float64 <= 5e-6 at 20 layers with a 20-layer / 10-layer ratio <= 1.6 (a
   bias grows linearly with the windows, 2.0; rounding to nearest about
   1.4). A miss stops the run;
4. the serving slice at n=18, 5 layers: the bench ansatz (rx/rz/rx per
   wire plus a CNOT ring, X string on all wires) through the public
   QubitCircuit API on the default device (the card) at complex64 with
   params from init_para(seed): state and <X...X> against the port's
   complex128 einsum route on the card (<= 1e-5), window_chain_fwd launched
   exactly twice (forward + observable), and the median forward +
   expectation time on the kernel route and on the twin route;
5. the same at n=24 (window_apply route) and at n=22 with one extra
   cnot(0, 11) per layer (planar_apply >= 5 launches, window_apply > 0);
6. the training slice at n=18, 5 layers: one step = forward, expectation,
   backward, SGD update, with the parameters a leaf that requires grad.
   Loss and gradient against the complex128 route with plain autograd
   (<= 1e-5, <= 1e-4); per step window_chain_fwd launched exactly twice and
   window_chain_bwd once; three SGD steps on both routes from the same
   parameters give losses within 1e-5 after every step; the median step
   time on the kernel route and on the twin route;
7. the per-step backward at n=22 with cnot(0, 11) per layer, 2 layers: the
   default route launches planar_grad >= 2, planar_apply and window_apply;
   with fused_bwd it launches planar_bwd_fused >= 2 and planar_grad 0; both
   gradients against complex128 (<= 1e-4) and against each other (<= 1e-5);
   the median grad step on the kernel route and on the twin route;
7b. the batched QML step (benchmarks/bench_suite.py::bench_batched_qml):
   QubitCircuit(14, reupload=True), 2 layers of ry(encode), rz, ry per
   wire and a CNOT ring, Z on wire 0; data (100, 14) from default_rng(0);
   a step = expectation(data=feats, params=p) (100, 1), its mean, backward,
   SGD. Plain (feats = data) and hybrid (feats = data @ W + b): loss and
   gradients (p; W, b) against the complex128 route (<= 1e-5, <= 1e-4);
   per step, default and fused_bwd alike, one planar_chain_batched launch
   for the gates, one for the expectation's chain (counted apart), one
   planar_chain_batched_bwd launch and no per-step, window or window-chain
   kernel; gradients with fused_bwd <= 1e-5 from the default; three SGD
   steps on the kernel and twin routes (<= 1e-5 apart); medians on the
   kernel, per-step and twin routes in turns and the device's busy share
   from a profiler window; then the same ansatz at n=18, B=8, outside the
   chain's range: the per-step batched planar_apply and planar_grad
   (planar_bwd_fused with fused_bwd), no chain kernel, against complex128;
7c. noisy circuits (density matrices): bench_suite.py::bench_denmat's grad
   step (n=12, rho on 24 planar wires, 3 layers of rx, rz and a CNOT ring,
   depolarizing(0, 0.01) per layer as a superoperator on K1, X string on
   all wires) and the same at n=8 (16 wires): loss and gradient against
   the complex128 einsum route on the card (<= 1e-5, <= 1e-4), launches
   per step, peak memory, the medians of 10 steps on the kernel and twin
   routes in turns and the device's busy share; the batched noisy QML step
   (tests/test_planar.py's circuit, n=8, B=16: the batched chain and the
   per-sample superoperator on K1b / K5b) held the same way. In phase 3
   (check_superop_kernels) K1 / K5 on the depolarizing superoperator on
   (0, 12) at 24 wires and K1b / K5b on random non-unitary 4 x 4
   per-sample stacks at (16, 2, 2^16), against the twins (states 1e-6,
   planes PLANE_BAR), rows under ``superop``;
7d. QubitCircuit.hessian at bench_hessian's cell n=14, 1 layer (42 x 42):
   symmetric (1e-5) and <= 1e-4 of the complex128 einsum route's, the time
   of one call, its launches (the second-order walk on K1, K5 and K2) and
   the busy share of its gradient plus one column;
7e. measure with 10^6 shots from the n=18 served state and the n=12 noisy
   rho on a seeded generator of the card: a chi-square against the
   probabilities, no zero-probability outcome, the time of the call;
8. boson sampling at complex128: Clements(12 modes, 6 photons) with seeded
   angles gives 12376 probabilities from ONE permanent_cuda_batch launch
   (sum 1 within 1e-6, twin route within 1e-8), then get_amplitude of the
   all-ones outcome of a 20-mode, 20-photon mesh (one 20 x 20 permanent);
9. Gaussian boson sampling with click detectors at complex128:
   GaussianBosonSampling(10 modes, threshold) gives 1024 click-pattern
   probabilities, the 968 patterns of >= 3 clicks in exactly 8 batched
   tor_dets_cuda calls (one per click count 3..10) and no single one (sum 1
   within 1e-6, twin route within 1e-8); at 14 modes all 16384 patterns in
   12 batched calls (sum 1 within 1e-6, each pattern within its
   torontonian's bar of the twin route); with a displacement on two modes
   tor_dets_quads_cuda takes them instead; both routes' medians; then
   get_prob of the all-click pattern at 14 modes (one single call; 2m = 28,
   16383 subsets that cancel by 1e11: the routes agree to 1e-3), both ways;
9b. photonic gradients at complex128 (K7-K9 as autograd Functions whose
   backward is the twin's derivative): d P / d squeezing of GBS(10 modes,
   threshold) for three click patterns through tor_dets_cuda (three
   single launches of get_prob, then the same from the full table: 8
   batched calls), displaced through tor_dets_quads_cuda, and d P / d
   angles of three Clements(12, 6 photons) probabilities through one
   permanent_cuda_batch launch, each <= 1e-8 of the twin route's autograd;
9c. QuantumFourierTransform(24) on |x> (x from the seed): 24 h, 276 cp, 12
   swap on K2 windows and K1; the state against the analytic transform
   (numpy complex128) and the complex128 route (<= 1e-5), QFT^-1 back to
   |x> (<= 1e-5), launches, medians of the kernel and twin routes;
9d. the QCNN training step at n=18 (QuantumConvolutionalNeuralNetwork(18,
   3): 18 -> 9 -> 5 -> 3 wires, 42 shared trainable parameters, the
   latent gate's 64 fixed on 3 wires as in the JAX package, Z on wire 0):
   loss and gradient against complex128 (<= 1e-5 / <= 1e-4), three SGD
   steps on the kernel and twin routes (<= 1e-5), launches, medians in
   turns, busy share;
9e. make_adjoint_expectation at bench_gradient_adjoint's cell n=18, 5
   layers (the planar chain's adjoint backward: K3 / K4) against the
   complex128 einsum route with plain autograd, phase 6's reference
   (<= 1e-5 / <= 1e-4); its einsum-route Function at n=14 in
   complex128 against autograd (<= 1e-10); make_layered_vqe(18, 5) against
   the circuit it mirrors (<= 1e-5 / <= 1e-4);
9f. conditional gates at n=20 (h on wires 0-9, x(10 + i) conditioned on
   wire i, the bench layers on 10-19; the einsum route): the state against
   complex128 (<= 1e-5), defer_measure from a seeded card generator (norm
   1 within 1e-5, its probability get_prob's within 1e-5), post_select the
   same state; the time of each call;
9g. MPS at n=100, chi=64, 8 layers of rx, rz, rx and a CNOT chain (the
   bond truncates at 64): <Z0> and its gradient at complex64 against
   complex128 on the card (<= 1e-4, <= 1e-3 of max|g|), the norm (<= 1e-4),
   10^4 shots of wire 0 within 5 sigma, the 100-qubit GHZ state's two
   strings by a chi-square, exactness at n=16, 5 layers, chi=256 against
   the kernel state vector (state, <Z0> <= 1e-5, gradient <= 1e-4); times,
   SVD / QR calls a step, and the busy share of one layer's value and
   gradient at full bond (the last layer, from the first seven's MPS: a
   profiler window over the whole step costs ~150 s). In phase 3 check_superop_kernels
   also times the one torch.einsum of K1 / K5 / K1b / K5b's superoperator
   rows (library_ms);
9h. graph GBS (check_graph_gbs; Arrazola & Bromley, PRL 121, 030503): GraphGBS
   on G(14, 1/2) with a planted 6-clique, 14 photons on average, threshold
   detectors, complex128: all 16 384 patterns in 12 batched K8 calls (sum
   1 within 1e-6), measure(10^5 shots) by a chi-square against the table,
   postselect on 6 and 8 clicks (graph_density only where networkx is
   installed); the 10-node subgraph with pnrd detectors, cutoff 2: 1024
   outcomes, one hafnian_batch call per photon number, complex64 within
   1e-6 of complex128;
9i. lossy GBS (check_lossy_gbs): path (b)'s 14-mode GBS with loss_db(3.0)
   on every mode: the click table (12 batched K8 calls; displaced, 12 K9)
   and measure(10^5 shots) by a chi-square; homodyne conditioning on 4 of
   the 14 modes with given outcomes, complex64 within 1e-6 of complex128;
9j. time-domain multiplexing (check_tdm): Borealis-like loops of 1, 6 and
   36 bins (Madsen et al., Nature 606, 75; 44 concurrent modes, data
   (64, 216, 6), 216 steps) and a 2-D cluster source with delays of 1 and
   12 (Asavanant et al., Science 366, 373; 200 steps), complex64 against
   complex128 on one generator seed: every step's covariance within 1e-5;
   ms per step, peak memory, busy share;
9k. the Bosonic backend (check_bosonic), complex128: two cats and a GKP
   state (16 x the GKP's components), beam splitters, measure_homodyne
   (1000 shots) through a conditional homodyne, the Wigner function of
   mode 0 on 100 x 100 points (integral within 1e-3), quadrature means
   and photon statistics, the rejection sampler's x of mode 0 by a
   chi-square against its marginal. Each of 9h-9k prints its time, K8b /
   K9b wrapper calls, peak memory and busy share;
9l. the CV-QNN training step on Fock tensors (check_fock_qnn; Killoran et
   al., arXiv:1806.06871): 2 layers on 7 modes at cutoff 10 (10^7
   amplitudes, 182 operations), the value and gradient of sum <n>, three
   SGD steps; complex64 against the port's complex128 run on the card
   (state 1e-5 of max|amp|, value 1e-5, gradient 1e-4 of max|g|, the
   losses 1e-5); the median step, busy share, peak memory, and the time
   of building the Fock matrices (a gate family a call, and one gate a
   call) against contracting them;
9m. a lossy Fock density matrix (check_fock_dm): one CV-QNN layer on 4
   modes at cutoff 8 (8^8 entries), loss_db(3) on every mode; forward,
   value and gradient of sum <n>, quadrature_mean, wigner(0) on 100 x 100
   points (integral within 1e-3 of the trace), measure(10^5) by a
   chi-square against the diagonal; complex64 against complex128;
9n. the Fock MPS (check_fock_mps): one layer on 8 modes at cutoff 4 with
   chi = 256 (exact) against the dense tensor (1e-5), then 16 modes,
   chi = 32: forward and measure(1000);
9o. homodyne on Fock tensors (check_fock_homodyne): measure_homodyne(10^4)
   on mode 0 of 9l's state by a chi-square against its grid pdf, a
   conditional homodyne(0) in a 4-mode circuit with given outcomes
   (complex64 against complex128), per-forward noise from an explicit
   generator bitwise the same over two runs with one seed. 9l-9o launch
   none of the port's kernels (asserted);
9p. the class-style API and QASM (check_class_api_qasm): the bench ansatz
   at n=18, 5 layers, built from RxLayer / RzLayer / CnotRing with the
   sugar-built circuit's parameters: state and <X...X> against the sugar
   (1e-6), gradient (1e-5), window_chain_fwd launched twice; qasm3() and
   qasm3_to_cir of its text on the card, the state again (1e-5), the
   export and import times;
9q. circuit cutting (check_cutting): two 12-wire halves of the bench
   ansatz (5 layers each) joined by a cnot each way across the middle,
   two wire cuts: 64 terms, 128 subcircuits of 13 wires on the card; the
   reconstructed <Z Z> of the crossing wires against the uncut n=24 circuit at complex64
   and complex128 (1e-5); the host time to build the subexperiments and
   the time to run them, their K1 / K2 / K3 launches, the busy share;
9r. MBQC at complex128 (check_mbqc): QubitCircuit.pattern() of random
   5-qubit circuits of the MBQC family whose standard pattern's first
   measurement materialises a graph state of >= 20 nodes (2^20
   amplitudes on the card), unstandardised and standardised at three
   generator seeds each, the output's overlap with the circuit's state
   >= 1 - 1e-8; nodes, the largest state, ms per pattern, busy share;
9s. the gradient-free optimizers (check_optimizers): OptimizerSPSA (10
   steps, every parameter) and OptimizerFourier (order 2, 3 steps on the
   12 angles of the last rz column) on the n=12 bench loss on the card: the loss falls; the ms of
   a target evaluation. Each of 9l-9s prints its wall seconds in the
   line of phase times;
9t. the shardmap engine at full width (check_shardmap): the bench ansatz
   at n=28, 5 layers, complex64 (2 GiB of state) as a
   DistributedQubitCircuit on make_mesh(devices=['cuda:0'] * 4) (2
   global qubits, 512 MiB a shard): forward, expectation and the
   gradient step against the local QubitCircuit(28) with the same
   parameters, run in turn (state 1e-5 of max|amp|, value 1e-5,
   gradient 1e-4 of max|g|); the world-size-1 mesh's state against the
   local one (1e-6); the step again with cir.fused_bwd = False (K1 + K5 +
   K1 in place of K6), its gradient 1e-5 of max|g| from the fused one;
   the step through expectation(adjoint=True) (the same engine, K1 and K6
   launched), value and gradient against the local engine; K1, K2, K5 and
   K6 launched; the forward and step ms (CUDA-event medians of 3), the
   launches per kernel and the 'run' / 'g1' / 'remap' step counts, the
   device time in the exchanges (half-shard swaps and 'g1' blends)
   against the local runs and their relabels (CUDA events around each),
   the busy share and the peak memory;
9u. the 'gspmd' engine at complex128 (check_gspmd): the bench ansatz at
   n=24, 5 layers, on 2 shards of the card against the local complex128
   circuit (state and value 1e-10); expectation(adjoint=True) on the mesh
   against autograd of the same mesh (1 layer: autograd keeps 256 MiB a
   gate; value and gradient 1e-8); measure(10^5, wires=[0, 1, 2, 3])
   across the global and local qubits by a chi-square against the local
   state's marginal;
9v. the sharded Fock tensor (check_sharded_fock): 9l's CV-QNN (7 modes,
   cutoff 10, 10^7 amplitudes) as a DistributedQumodeCircuit on 2 shards
   of the card: the forward against the local Fock tensor (complex64,
   1e-5 of max|amp|), measure(10^5) by a chi-square on mode 0's marginal,
   the per-forward noise bitwise the same over two runs with one
   generator seed; the forward ms, peak memory. 9t-9v print their wall
   seconds in the line of phase times; tools/distributed_phases.py runs
   them alone;
10. print the kernels' JSON line (sixteen rows: the nine kernels, the
   batched forms of K1, K5, K6, K8, K9 and the two entries of the batched
   gate chain, each with its launches on the main paths), the card line,
   and last {"ok": true, "device": {...}}.

Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 1234
LAYERS = 5
REPS = 20
LR = 1e-3
# reduced cotangent planes (dRe, dIm, dW) against max|ref|: float32 sums of up
# to 2^21 products taken in another order than the twin's matmul; the card
# reads 1.6e-6 to 2.0e-6
PLANE_BAR = 1e-5
# the float32 twin of the cotangent reduction against the same in float64 at
# n=18, B=8 on amplitude bit 0: 1.38e-5 as one matmul over 2^17 positions,
# summed in blocks of 2^8 (planar_grad_xla) it must stay under this
TWIN32_BAR = 1e-6

# published peaks of one H100 SXM at its full power limit
PEAK_BYTES_S = 3.35e12       # device memory
PEAK_FP32_S = 67e12          # float32 outside the tensor cores
PEAK_FP64_S = 34e12          # float64 outside the tensor cores
PEAK_TF32_S = 495e12         # TF32 on the tensor cores (dense)
PEAK_FP64_TC_S = 67e12       # FP64 on the tensor cores (DMMA, dense)
# the window kernels under depth: the kernel against the twin run in float64
# at the deepest walk, and the growth of that error from the shallower walk
DEPTH_BAR = 5e-6
DEPTH_RATIO = 1.6

KERNELS = {   # wrapper -> (source, TPU kernel it replaces)
    'planar_apply': ('deepquantum_tpu_torch/csrc/planar_apply.cu',
                     'deepquantum_tpu/ops/planar_gate.py:412'),
    'window_apply': ('deepquantum_tpu_torch/csrc/window_apply.cu',
                     'deepquantum_tpu/ops/window_gate.py:92'),
    'window_chain_fwd': ('deepquantum_tpu_torch/csrc/window_chain.cu',
                         'deepquantum_tpu/ops/chain_kernel.py:294'),
    'window_chain_bwd': ('deepquantum_tpu_torch/csrc/window_chain_bwd.cu',
                         'deepquantum_tpu/ops/chain_kernel.py:324'),
    'planar_grad': ('deepquantum_tpu_torch/csrc/planar_grad.cu',
                    'deepquantum_tpu/ops/planar_gate.py:560'),
    'planar_bwd_fused': ('deepquantum_tpu_torch/csrc/planar_bwd_fused.cu',
                         'deepquantum_tpu/ops/planar_gate.py:687'),
    'permanent_cuda_batch': ('deepquantum_tpu_torch/csrc/permanent_ryser.cu',
                             'deepquantum_tpu/ops/pallas_kernels.py:228'),
    'tor_dets_cuda': ('deepquantum_tpu_torch/csrc/tor_lu.cu',
                      'deepquantum_tpu/photonic/tor_kernel.py:188'),
    'tor_dets_quads_cuda': ('deepquantum_tpu_torch/csrc/tor_lu.cu',
                            'deepquantum_tpu/photonic/tor_kernel.py:230'),
    # the batched forms of K1, K5, K6 ((B, 2, 2^n) stacks, the JAX kernels'
    # leading batch grid axis): the same sources, counted apart
    'planar_apply_batched': ('deepquantum_tpu_torch/csrc/planar_apply.cu',
                             'deepquantum_tpu/ops/planar_gate.py:412'),
    'planar_grad_batched': ('deepquantum_tpu_torch/csrc/planar_grad.cu',
                            'deepquantum_tpu/ops/planar_gate.py:560'),
    'planar_bwd_fused_batched': ('deepquantum_tpu_torch/csrc/planar_bwd_fused.cu',
                                 'deepquantum_tpu/ops/planar_gate.py:687'),
    # the vmapped K8 / K9 (torontonian_batch: a (B, 2m, 2m) stack, the batch a
    # grid axis of each size bucket's pallas_call): the same source, counted apart
    'tor_dets_cuda_batched': ('deepquantum_tpu_torch/csrc/tor_lu.cu',
                              'deepquantum_tpu/photonic/tor_kernel.py:188'),
    'tor_dets_quads_cuda_batched': ('deepquantum_tpu_torch/csrc/tor_lu.cu',
                                    'deepquantum_tpu/photonic/tor_kernel.py:230'),
    # K1b / K6b redesigned: a batched gate chain in one launch per direction,
    # each sample's state in shared memory (the per-step batched K1 / K6 stay
    # for chains outside its range)
    'planar_chain_batched': ('deepquantum_tpu_torch/csrc/planar_chain_batched.cu',
                             'deepquantum_tpu/ops/planar_gate.py:412'),
    'planar_chain_batched_bwd': ('deepquantum_tpu_torch/csrc/planar_chain_batched.cu',
                                 'deepquantum_tpu/ops/planar_gate.py:687'),
}
# the kernel functions of csrc/, as the profiler names them
PORT_KERNEL = (r'\(anonymous namespace\)::(planar_apply|planar_grad|planar_bwd_fused|window_apply|'
               r'window_chain_fwd|window_chain_bwd|ryser|tor_lu|chain_fwd|chain_bwd)_kernel\b')
BATCHED = {'planar_apply_batched': 'planar_apply', 'planar_grad_batched': 'planar_grad',
           'planar_bwd_fused_batched': 'planar_bwd_fused',
           'tor_dets_cuda_batched': 'tor_dets_cuda',
           'tor_dets_quads_cuda_batched': 'tor_dets_quads_cuda'}
PLANAR_BATCHED = ('planar_apply_batched', 'planar_grad_batched', 'planar_bwd_fused_batched')
GATE_WIRE_SETS = [(0,), (21,), (10,), (0, 1), (3, 17), (20, 21), (0, 10, 21), (5, 6, 7)]


def _pkg():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import deepquantum_tpu_torch as dqt
    from deepquantum_tpu_torch.ops import chain_kernel, planar_gate, window_gate
    return dqt, planar_gate, window_gate, chain_kernel


def _chain_mod():
    _pkg()
    from deepquantum_tpu_torch.ops import planar_chain_batched
    return planar_chain_batched


def _photonic():
    _pkg()
    from deepquantum_tpu_torch.ops import permanent_kernel
    from deepquantum_tpu_torch.photonic import qmath, tor_kernel, torontonian_
    return permanent_kernel, qmath, tor_kernel, torontonian_


def _wrappers():
    """Row name -> (wrapper, the attribute its launches count in): a
    batched row reads the same wrapper's ``batched_launches``."""
    _, pg, wg, ck = _pkg()
    pk, _, tk, _ = _photonic()
    pcb = _chain_mod()
    fns = {'planar_apply': pg.planar_apply, 'window_apply': wg.window_apply,
           'window_chain_fwd': ck.window_chain_fwd, 'window_chain_bwd': ck.window_chain_bwd,
           'planar_grad': pg.planar_grad, 'planar_bwd_fused': pg.planar_bwd_fused,
           'permanent_cuda_batch': pk.permanent_cuda_batch, 'tor_dets_cuda': tk.tor_dets_cuda,
           'tor_dets_quads_cuda': tk.tor_dets_quads_cuda,
           'planar_chain_batched': pcb.planar_chain_batched,
           'planar_chain_batched_bwd': pcb.planar_chain_batched_bwd}
    out = {name: (fn, 'launches') for name, fn in fns.items()}
    out.update({name: (fns[single], 'batched_launches') for name, single in BATCHED.items()})
    return out


def reset_counts():
    for fn, attr in _wrappers().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in _wrappers().items()}


def time_ms(fn, reps: int = REPS, warmup: int = 2):
    """Median and all per-call times of fn() on the card, with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def rel_err(y, ref):
    d = (y - ref).abs().max().item()
    return d / ref.abs().max().item(), d


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32_S) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def mean_bound(bounds) -> dict:
    ms = float(np.mean([b['bound_ms'] for b in bounds]))
    kinds = {b['bound_by'] for b in bounds}
    if len(kinds) != 1:
        raise AssertionError(f'mixed bounds {kinds} in one mean')
    return dict(bound_ms=ms, bound_by=kinds.pop())


@contextlib.contextmanager
def complex128():
    """The photonic phases run at the complex128 policy (K7-K9 compute in
    float64 either way; the policy sets the type of the circuit's matrices
    and of the values returned)."""
    dqt = _pkg()[0]
    dqt.set_dtype('complex128')
    try:
        yield
    finally:
        dqt.set_dtype('complex64')


@contextlib.contextmanager
def twin_route():
    """Run the planar engine's steps, forward and backward, and the photonic
    sweeps through the plain twins on the card (the same contracts as the
    kernel wrappers)."""
    _, pg, wg, ck = _pkg()
    pk, pq, tk, pt = _photonic()
    pcb = _chain_mod()

    def planar(x, mre, mim, n, wires):
        x.copy_(pg.planar_evolve_xla(x, mre, mim, n, wires))
        return x

    def window(x, mre, mim, n, w):
        x.copy_(wg.window_apply_plain(x, mre, mim, n, w))
        return x

    def bwd_fused(y, g, mre_t, mim_t, n, wires):
        x, g2, dre, dim = pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
        y.copy_(x)
        g.copy_(g2)
        return y, g, dre, dim

    patches = [(pg, 'planar_apply', planar), (wg, 'window_apply', window),
               (ck, 'window_chain_fwd', ck.window_chain_plain),
               (ck, 'window_chain_bwd', ck.window_chain_bwd_plain),
               (pg, 'planar_grad', pg.planar_grad_xla), (pg, 'planar_bwd_fused', bwd_fused),
               (pq, 'permanent_cuda_batch', pk.permanent_plain_batch),
               (pt, 'tor_dets_cuda', tk.tor_dets_plain),
               (pt, 'tor_dets_quads_cuda', tk.tor_dets_quads_plain),
               (pcb, 'planar_chain_batched', pcb.planar_chain_batched_plain),
               (pcb, 'planar_chain_batched_bwd',
                lambda y, g, chain: pcb.planar_chain_batched_plain(y, chain, g))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def bench_circuit(n: int, device=None, extra_cnot=None, layers: int = LAYERS):
    """The bench ansatz: layers x (rx, rz, rx on every wire; CNOT ring),
    optionally one more cnot per layer; X string on all wires. With no
    device it lands on the port's default device, the card."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(n, device=device)
    for _ in range(layers):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
        if extra_cnot is not None:
            cir.cnot(*extra_cnot)
    cir.observable(list(range(n)), basis='x' * n)
    cir.init_para(SEED)
    return cir


def _haar(k: int, rng) -> np.ndarray:
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _planes(u, device):
    import torch
    return (torch.as_tensor(u.real, dtype=torch.float32, device=device),
            torch.as_tensor(u.imag, dtype=torch.float32, device=device))


def _randn_state(n: int, rng, device):
    import torch
    return torch.as_tensor(rng.standard_normal((2, 1 << n), dtype=np.float32), device=device)


def window_bounds(nbytes: float, flops: float) -> dict:
    """K2, K3 and K4 run their float32 products on the FP64 tensor cores
    (csrc/window_mma.cuh): bound_ms is the operations at the DMMA peak or
    the bytes; bound_tf32x3_ms is what the 3xTF32 body (3 x the operations
    at the TF32 peak) would be held to."""
    tf32 = bound(nbytes, 3 * flops, PEAK_TF32_S)
    return dict(bound(nbytes, flops, PEAK_FP64_TC_S), bound_tf32x3_ms=tf32['bound_ms'],
                bound_tf32x3_by=tf32['bound_by'])


def _shares(r: dict) -> str:
    return (f'bound {r["bound_ms"]:.4f} ms on the FP64 tensor cores ({r["bound_by"]}, '
            f'{r["bound_ms"] / r["ms"]:.0%}), {r["bound_tf32x3_ms"]:.4f} ms in 3xTF32 '
            f'({r["bound_tf32x3_by"]}, {r["bound_tf32x3_ms"] / r["ms"]:.0%})')


def _hold(name: str, err: float, bar: float):
    if not err <= bar:
        raise AssertionError(f'{name}: rel err {err} > {bar}')


# ------------------------------------------------------------------ phases
def setup():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('FAIL: torch.cuda.is_available() is false; this check needs a CUDA card')
    if not (ROOT / 'deepquantum_tpu_torch' / 'csrc').is_dir():
        raise SystemExit('FAIL: deepquantum_tpu_torch/ is not beside chip_smoke.py')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f'card: {smi}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}')
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    if dqt.default_device().type != 'cuda':
        raise AssertionError(f'the default device is {dqt.default_device()}, not the card')
    return smi


def _kernel_name(mangled: str) -> str:
    """'_ZN..._15_planar_apply_cu_f1d3476e19planar_apply_kernelILi3ELb1EEEv...'
    -> 'planar_apply_kernel<3,1>': the length-prefixed identifier that ends
    in 'kernel', and the integer template arguments."""
    for m in re.finditer(r'(?=(\d+)([A-Za-z_]\w*))', mangled):
        ident = m.group(2)[:int(m.group(1))]
        if len(ident) == int(m.group(1)) and ident.endswith('kernel'):
            args = re.findall(r'L[ib](\d+)E', mangled)
            return ident + (f'<{",".join(args)}>' if args else '')
    return mangled


# kernels that must not spill (ptxas -v): K1, K5 and K6 on the float4 plan,
# eight instances each
NO_SPILL = ('planar_apply_kernel', 'planar_grad_kernel', 'planar_bwd_fused_kernel')


def build():
    """Build the kernels and print the build time and each kernel's
    registers and spills; a spill in a NO_SPILL kernel fails the run. K7's
    instances (one per column capacity NMAX) are printed again on one line."""
    from deepquantum_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    path = _cuda.build()
    print(f'build: {time.perf_counter() - t0:.1f} s -> {path.relative_to(ROOT)}')
    name, spill, spilled, seen, ryser = '?', '', [], set(), []
    for line in _cuda.build_log.splitlines():
        if 'Compiling entry function' in line:
            name = _kernel_name(line.split("'")[1])
        elif 'spill' in line:
            spill = line.strip()
        elif 'Used' in line and 'registers' in line:
            print(f'  nvcc: {name}: {line.split(":", 1)[1].strip()}; {spill}')
            if name.startswith('ryser_kernel'):
                regs = re.search(r'Used (\d+) registers', line)
                ryser.append(f'{name} {regs.group(1) if regs else "?"} registers, {spill}')
            if name.startswith(NO_SPILL):
                seen.add(name)
                if re.search(r'[1-9]\d* bytes spill (stores|loads)', spill):
                    spilled.append(name)
        elif 'error' in line.lower():
            print(f'  nvcc: {line.strip()}')
    if ryser:
        print(f'K7 instances <NMAX,ways>: {"; ".join(ryser)}')
    want = 8 * len(NO_SPILL)
    if _cuda.build_log and (spilled or len(seen) < want):
        raise AssertionError(f'ptxas: {spilled} spill; {len(seen)} of the {want} instances of '
                             f'{NO_SPILL} reported')


def _mean_or_none(values):
    values = [v for v in values if v is not None]
    return float(np.mean(values)) if values else None


def _segment_view(x, n: int, wires, gate: str, runs: str = 'abcd'):
    """x (..., 2, 2^n) viewed as (..., 2, segments): the amplitude axis cut
    around the sorted gate wires into runs of other bits and one axis of 2
    per gate bit; with the einsum subscripts of the segments (``gate``: the
    letters of the gate bits, in wire order)."""
    shape, sub, prev = [], '', -1
    for j, w in enumerate(wires):
        shape += [1 << (w - prev - 1), 2]
        sub += runs[j] + gate[j]
        prev = w
    shape.append(1 << (n - 1 - prev))
    sub += runs[len(wires)]
    return x.view(tuple(x.shape[:-1]) + tuple(shape)), sub


def library_apply_ms(x, mre, mim, n: int, wires, ref, name: str) -> float:
    """The library yardstick of K1 / K1b, used nowhere in the port: ONE
    torch.einsum of the gate's real block form [[Re, -Im], [Im, Re]] (per
    sample for (B, K, K) planes; built here, outside the timed call) with
    the state viewed as (..., 2, 2, ..., 2) around the gate's bits. Held
    against the twin's ``ref`` (<= 1e-5), then timed."""
    import torch
    k = len(wires)
    blk = torch.stack([torch.stack([mre, -mim], -3), torch.stack([mim, mre], -3)], -4)
    blk = blk.reshape(tuple(blk.shape[:-2]) + (2,) * (2 * k))
    xv, sub_in = _segment_view(x, n, wires, 'efg')
    _, sub_out = _segment_view(x, n, wires, 'hij')
    bz, xz = 'z' * (mre.dim() == 3), 'z' * (x.dim() == 3)
    eq = f'{bz}PQ{"hij"[:k]}{"efg"[:k]},{xz}Q{sub_in}->{xz}P{sub_out}'
    e = rel_err(torch.einsum(eq, blk, xv).reshape(x.shape), ref)[0]
    _hold(f'{name}: the library einsum', e, 1e-5)
    return time_ms(lambda: torch.einsum(eq, blk, xv))[0]


def library_grad_ms(g, x, n: int, wires, ref, name: str) -> float:
    """The library yardstick of K5 / K5b, used nowhere in the port: ONE
    torch.einsum of a constant (2, 2, 2) sign tensor with g and x viewed
    around the gate's bits, dW_re = g_re x_re + g_im x_im and dW_im =
    g_im x_re - g_re x_im summed over the other bits. Held against the
    twin's ``ref`` (dRe, dIm) (<= 1e-5), then timed."""
    import torch
    k, kk = len(wires), 1 << len(wires)
    sign = torch.zeros(2, 2, 2, device=x.device)
    sign[0, 0, 0] = sign[0, 1, 1] = sign[1, 1, 0] = 1.0
    sign[1, 0, 1] = -1.0
    gv, sub_g = _segment_view(g, n, wires, 'hij')
    xv, sub_x = _segment_view(x, n, wires, 'efg')
    z = 'z' * (x.dim() == 3)
    eq = f'OPQ,{z}P{sub_g},{z}Q{sub_x}->{z}O{"hij"[:k]}{"efg"[:k]}'
    out = torch.einsum(eq, sign, gv, xv).reshape(tuple(x.shape[:-2]) + (2, kk, kk))
    e = max(rel_err(out[..., 0, :, :], ref[0])[0], rel_err(out[..., 1, :, :], ref[1])[0])
    _hold(f'{name}: the library einsum', e, 1e-5)
    return time_ms(lambda: torch.einsum(eq, sign, gv, xv))[0]


def planar_grad_ref(pg, g, x, n: int, wires):
    """The planes K5 / K5b are held to, ``planar_grad_xla`` on the inputs
    widened to float64, and the float32 twin's own error against them. The
    float32 twin is no reference at every shape: its batched matmul may add
    the 2^(n-k) products of an element one after another (at n=18, B=8 on
    amplitude bit 0 it read 1.4e-5 from the kernel, which the float64 twin
    puts on the float32 twin's side)."""
    ref = pg.planar_grad_xla(g.double(), x.double(), n, wires)
    return ref, max(rel_err(a.double(), b)[0]
                    for a, b in zip(pg.planar_grad_xla(g, x, n, wires), ref))


def planar_bwd_fused_ref(pg, y, g, mre_t, mim_t, n: int, wires):
    """The cotangent planes K6 / K6b are held to: its plain twin on the
    inputs widened to float64 (the planes are K5's sums; see
    planar_grad_ref)."""
    return pg.planar_bwd_fused_plain(y.double(), g.double(), mre_t.double(), mim_t.double(),
                                     n, wires)[2:]


def check_gate_kernels(results: dict, rng, rng_g):
    """Phase 3, the per-gate kernels K1, K5, K6 at n=22 on eight wire sets.
    States and unitaries come from ``rng`` in a fixed order, cotangents from
    ``rng_g``, so that adding a kernel leaves the others' inputs as they were."""
    import torch
    pg = _pkg()[1]
    dev = torch.device('cuda')
    n = 22
    state_bytes = 2 * (1 << n) * 4          # one (2, 2^n) float32 state
    x = _randn_state(n, rng, dev)
    g = _randn_state(n, rng_g, dev)
    acc = {name: dict(errs=[], abs_errs=[], plane_errs=[], t_k=[], t_p=[], t_l=[], bounds=[],
                      t_d=[], t_c=[])
           for name in ('planar_apply', 'planar_grad', 'planar_bwd_fused')}
    twin32 = []

    def note(name, wires, e, d, pe, tk, tp, bnd, tl=None, td=None, tc=None):
        a = acc[name]
        for key, v in (('errs', e), ('abs_errs', d), ('plane_errs', pe), ('t_k', tk),
                       ('t_p', tp), ('t_l', tl), ('bounds', bnd), ('t_d', td), ('t_c', tc)):
            a[key].append(v)
        errs = ', '.join(f'{what} rel err {v:.2e}' for what, v in (('state', e), ('plane', pe))
                         if v is not None)
        lib = '' if tl is None else f', one einsum {tl:.4f} ms'
        dev = '' if td is None else (f', device {td:.4f} ms (warm L2), {tc:.4f} ms (L2 flushed; '
                                     f'{bnd["bound_ms"] / tc:.0%} of the bound)')
        print(f'{name} n={n} wires={wires}: {errs}, kernel {tk:.4f} ms{dev}, twin {tp:.4f} '
              f'ms{lib}, bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]})')

    for wires in GATE_WIRE_SETS:
        k = len(wires)
        apply_flops = (1 << (n - k)) * 8 * 4 ** k       # a complex (2^k)^2 product per group
        mre, mim = _planes(_haar(1 << k, rng), dev)
        mre_t, mim_t = mre.t().contiguous(), (-mim.t()).contiguous()

        # K1: y = U x
        ref = pg.planar_evolve_xla(x, mre, mim, n, wires)
        y = pg.planar_apply(x.clone(), mre, mim, n, wires)
        torch.cuda.synchronize()
        e, d = rel_err(y, ref)
        _hold(f'planar_apply wires={wires}', e, 1e-6)
        work = x.clone()
        tk, _ = time_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))
        td = _queued_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))
        tc = _cold_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))
        tp, _ = time_ms(lambda: pg.planar_evolve_xla(x, mre, mim, n, wires))
        tl = library_apply_ms(x, mre, mim, n, wires, ref, f'planar_apply wires={wires}')
        note('planar_apply', wires, e, d, None, tk, tp, bound(2 * state_bytes, apply_flops), tl,
             td, tc)

        # K5: (dRe, dIm) from g and x, pure reads; held to the twin run in
        # float64 (the float32 twin's own error beside it)
        ref, t32 = planar_grad_ref(pg, g, x, n, wires)
        got = pg.planar_grad(g, x, n, wires)
        torch.cuda.synchronize()
        pe, pd = max(rel_err(a.double(), b) for a, b in zip(got, ref))
        _hold(f'planar_grad wires={wires}', pe, PLANE_BAR)
        twin32.append(t32)
        print(f'planar_grad n={n} wires={wires}: kernel {pe:.2e}, float32 twin {t32:.2e} '
              'of the float64 twin')
        again = pg.planar_grad(g, x, n, wires)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f'planar_grad wires={wires}: dW differs between two launches')
        tk, _ = time_ms(lambda: pg.planar_grad(g, x, n, wires))
        td = _queued_ms(lambda: pg.planar_grad(g, x, n, wires))
        tc = _cold_ms(lambda: pg.planar_grad(g, x, n, wires))
        tp, _ = time_ms(lambda: pg.planar_grad_xla(g, x, n, wires))
        tl = library_grad_ms(g, x, n, wires, ref, f'planar_grad wires={wires}')
        note('planar_grad', wires, None, pd, pe, tk, tp,
             bound(2 * state_bytes + 2 * 4 ** k * 4, apply_flops), tl, td, tc)
        if wires == GATE_WIRE_SETS[-2]:
            check_one_launch(lambda: pg.planar_grad(g, x, n, wires), 5,
                             f'planar_grad n={n} wires={wires}')

        # K6: x = U^H y, g' = U^H g, planes from the raw g, in place on both
        ref = pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
        wy, wg_ = y.clone(), g.clone()
        got = pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires)
        torch.cuda.synchronize()
        if got[0] is not wy or got[1] is not wg_:
            raise AssertionError('planar_bwd_fused must update y and g in place')
        (e, d), (e2, d2) = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
        e, d = max(e, e2), max(d, d2)
        _hold(f'planar_bwd_fused states wires={wires}', e, 1e-5)
        _hold(f'planar_bwd_fused recovers x wires={wires}', rel_err(got[0], x)[0], 1e-5)
        ref = planar_bwd_fused_ref(pg, y, g, mre_t, mim_t, n, wires)
        pe, pd = max(rel_err(a.double(), b) for a, b in zip(got[2:], ref))
        _hold(f'planar_bwd_fused planes wires={wires}', pe, PLANE_BAR)
        again = pg.planar_bwd_fused(y.clone(), g.clone(), mre_t, mim_t, n, wires)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f'planar_bwd_fused wires={wires}: dW differs between two launches')
        tk, _ = time_ms(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires))
        td = _queued_ms(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires))
        tc = _cold_ms(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires))
        tp, _ = time_ms(lambda: pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires))
        note('planar_bwd_fused', wires, e, max(d, pd), pe, tk, tp,
             bound(4 * state_bytes + 2 * 4 ** k * 4, 3 * apply_flops), None, td, tc)
        if wires == GATE_WIRE_SETS[-2]:
            check_one_launch(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires), 5,
                             f'planar_bwd_fused n={n} wires={wires}', 'planar_bwd_fused_kernel')

    for name, a in acc.items():
        states = [v for v in a['errs'] if v is not None]
        planes = [v for v in a['plane_errs'] if v is not None]
        results[name] = dict(max_abs_err=max(a['abs_errs']),
                             rel_err=max(states) if states else None,
                             plane_rel_err=max(planes) if planes else None,
                             ms=float(np.mean(a['t_k'])), plain_ms=float(np.mean(a['t_p'])),
                             library_ms=_mean_or_none(a['t_l']),
                             device_ms=_mean_or_none(a['t_d']), cold_ms=_mean_or_none(a['t_c']),
                             shape=f'n={n}, mean over {len(GATE_WIRE_SETS)} wire sets',
                             **mean_bound(a['bounds']))
        if results[name]['device_ms'] is None:
            del results[name]['device_ms'], results[name]['cold_ms']
    results['planar_grad']['twin32_rel_err'] = max(twin32)


# (n, B): the QML step's stack, a wide one, and the wide QML path's (past the
# batched chain's range), on amplitude bit 0, bits 0-1 and the top bit
BATCH_SHAPES = [(14, 100), (20, 8), (18, 8)]
BATCH_WIRES = {14: [(5,), (0, 13), (1, 7, 12)], 20: [(0,), (3, 17), (0, 10, 19)],
               18: [(17,), (16, 17), (0, 8, 16)]}


def check_batched_kernels(results: dict, rng):
    """Phase 3, the batched forms of K1, K5, K6 on (B, 2, 2^n) stacks with
    per-sample Haar planes at (n, B) = (14, 100) and (20, 8), k = 1, 2, 3,
    and K1 with one set of planes for every sample (stride 0): states
    <= 1e-6 of max|ref| (K6 1e-5, as the single form), planes <= 1e-5. Their
    own generator, so that the other kernels' inputs stay as they were."""
    import torch
    pg = _pkg()[1]
    dev = torch.device('cuda')
    rows = {name: [] for name in PLANAR_BATCHED}
    for n, b in BATCH_SHAPES:
        stack_bytes = b * 2 * (1 << n) * 4           # one (B, 2, 2^n) float32 stack
        acc = {name: dict(errs=[], abs_errs=[], plane_errs=[], t_k=[], t_p=[], t_l=[], bounds=[],
                          t_d=[])
               for name in PLANAR_BATCHED}
        twin32 = []
        x = torch.as_tensor(rng.standard_normal((b, 2, 1 << n), dtype=np.float32), device=dev)
        g = torch.as_tensor(rng.standard_normal((b, 2, 1 << n), dtype=np.float32), device=dev)

        def note(name, wires, e, d, pe, tk, tp, bnd, tl=None, td=None):
            a = acc[name]
            for key, v in (('errs', e), ('abs_errs', d), ('plane_errs', pe), ('t_k', tk),
                           ('t_p', tp), ('t_l', tl), ('bounds', bnd), ('t_d', td)):
                a[key].append(v)
            errs = ', '.join(f'{what} rel err {v:.2e}' for what, v in (('state', e), ('plane', pe))
                             if v is not None)
            lib = '' if tl is None else f', one einsum {tl:.4f} ms'
            print(f'{name} n={n} B={b} wires={wires}: {errs}, kernel {tk:.4f} ms, device '
                  f'{td:.4f} ms ({bnd["bound_ms"] / td:.0%} of the bound), twin {tp:.4f} ms{lib}, '
                  f'bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]})')

        for wires in BATCH_WIRES[n]:
            k = len(wires)
            flops = b * (1 << (n - k)) * 8 * 4 ** k
            us = np.stack([_haar(1 << k, rng) for _ in range(b)])
            mre = torch.as_tensor(us.real, dtype=torch.float32, device=dev)
            mim = torch.as_tensor(us.imag, dtype=torch.float32, device=dev)
            mre_t, mim_t = mre.transpose(1, 2).contiguous(), (-mim.transpose(1, 2)).contiguous()
            plane_bytes = 2 * b * 4 ** k * 4

            ref = pg.planar_evolve_xla(x, mre, mim, n, wires)
            y = pg.planar_apply(x.clone(), mre, mim, n, wires)
            torch.cuda.synchronize()
            e, d = rel_err(y, ref)
            _hold(f'planar_apply_batched n={n} B={b} wires={wires}', e, 1e-6)
            work = x.clone()
            tk, _ = time_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))
            td = _queued_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))
            tp, _ = time_ms(lambda: pg.planar_evolve_xla(x, mre, mim, n, wires))
            tl = library_apply_ms(x, mre, mim, n, wires, ref,
                                  f'planar_apply_batched n={n} B={b} wires={wires}')
            note('planar_apply_batched', wires, e, d, None, tk, tp,
                 bound(2 * stack_bytes + plane_bytes, flops), tl, td)

            ref, t32 = planar_grad_ref(pg, g, x, n, wires)
            got = pg.planar_grad(g, x, n, wires)
            torch.cuda.synchronize()
            pe, pd = max(rel_err(a.double(), r) for a, r in zip(got, ref))
            _hold(f'planar_grad_batched n={n} B={b} wires={wires}', pe, PLANE_BAR)
            twin32.append(t32)
            print(f'planar_grad_batched n={n} B={b} wires={wires}: kernel {pe:.2e}, float32 '
                  f'twin {t32:.2e} of the float64 twin')
            if (n, b, wires) == (18, 8, (17,)):   # its sums in blocks (planar_grad_xla)
                _hold(f'the float32 twin of planar_grad at n={n}, B={b} on amplitude bit 0', t32,
                      TWIN32_BAR)
            again = pg.planar_grad(g, x, n, wires)
            if not all(torch.equal(a, r) for a, r in zip(got, again)):
                raise AssertionError(f'planar_grad_batched n={n} B={b} wires={wires}: dW differs '
                                     'between two launches')
            tk, _ = time_ms(lambda: pg.planar_grad(g, x, n, wires))
            td = _queued_ms(lambda: pg.planar_grad(g, x, n, wires))
            tp, _ = time_ms(lambda: pg.planar_grad_xla(g, x, n, wires))
            tl = library_grad_ms(g, x, n, wires, ref,
                                 f'planar_grad_batched n={n} B={b} wires={wires}')
            note('planar_grad_batched', wires, None, pd, pe, tk, tp,
                 bound(2 * stack_bytes + plane_bytes, flops), tl, td)
            if (n, b) == BATCH_SHAPES[0] and k == 3:
                check_one_launch(lambda: pg.planar_grad(g, x, n, wires), 5,
                                 f'planar_grad_batched n={n} B={b} wires={wires}')

            ref = pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
            wy, wg_ = y.clone(), g.clone()
            got = pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires)
            torch.cuda.synchronize()
            if got[0] is not wy or got[1] is not wg_:
                raise AssertionError('planar_bwd_fused must update y and g in place')
            (e, d), (e2, d2) = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
            e, d = max(e, e2), max(d, d2)
            _hold(f'planar_bwd_fused_batched states n={n} B={b} wires={wires}', e, 1e-5)
            _hold(f'planar_bwd_fused_batched recovers x n={n} B={b} wires={wires}',
                  rel_err(got[0], x)[0], 1e-5)
            ref = planar_bwd_fused_ref(pg, y, g, mre_t, mim_t, n, wires)
            pe, pd = max(rel_err(a.double(), r) for a, r in zip(got[2:], ref))
            _hold(f'planar_bwd_fused_batched planes n={n} B={b} wires={wires}', pe, PLANE_BAR)
            again = pg.planar_bwd_fused(y.clone(), g.clone(), mre_t, mim_t, n, wires)
            if not all(torch.equal(a, r) for a, r in zip(got, again)):
                raise AssertionError(f'planar_bwd_fused_batched n={n} B={b} wires={wires}: dW '
                                     'differs between two launches')
            if (n, b) == BATCH_SHAPES[0] and k == 3:
                check_one_launch(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires), 5,
                                 f'planar_bwd_fused_batched n={n} B={b} wires={wires}',
                                 'planar_bwd_fused_kernel')
            tk, _ = time_ms(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires))
            td = _queued_ms(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires))
            tp, _ = time_ms(lambda: pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires))
            note('planar_bwd_fused_batched', wires, e, max(d, pd), pe, tk, tp,
                 bound(4 * stack_bytes + 2 * plane_bytes, 3 * flops), None, td)

        # K1 with one set of planes read by every sample (an observable's)
        wires = BATCH_WIRES[n][1]
        u = _haar(4, rng)
        mre, mim = _planes(u, dev)
        shared = (mre.expand(b, 4, 4), mim.expand(b, 4, 4))
        ref = pg.planar_evolve_xla(x, mre, mim, n, wires)
        y = pg.planar_apply(x.clone(), *shared, n, wires)
        torch.cuda.synchronize()
        e_sh, d_sh = rel_err(y, ref)
        _hold(f'planar_apply_batched shared planes n={n} B={b}', e_sh, 1e-6)
        work = x.clone()
        t_sh, _ = time_ms(lambda: pg.planar_apply(work, *shared, n, wires))
        print(f'planar_apply_batched n={n} B={b} wires={wires}, one set of planes for every '
              f'sample: rel err {e_sh:.2e}, kernel {t_sh:.4f} ms')

        for name, a in acc.items():
            states = [v for v in a['errs'] if v is not None]
            planes = [v for v in a['plane_errs'] if v is not None]
            row = dict(max_abs_err=max(a['abs_errs']), rel_err=max(states) if states else None,
                       plane_rel_err=max(planes) if planes else None,
                       ms=float(np.mean(a['t_k'])), plain_ms=float(np.mean(a['t_p'])),
                       library_ms=_mean_or_none(a['t_l']), device_ms=float(np.mean(a['t_d'])),
                       shape=f'n={n}, B={b}, mean over k = 1, 2, 3',
                       **mean_bound(a['bounds']))
            if name == 'planar_apply_batched':
                row.update(shared_planes_ms=t_sh, shared_planes_rel_err=e_sh)
                row['max_abs_err'] = max(row['max_abs_err'], d_sh)
            if name == 'planar_grad_batched':
                row['twin32_rel_err'] = max(twin32)
            rows[name].append(row)
        del x, g, y, work
    for name, r in rows.items():
        results[name] = dict(r[0], other_shapes=r[1:])


CHAIN_SHAPES = [(14, 100), (12, 256), (16, 8)]   # the QML stack; a wide batch; a full
                                                  # cluster of 8 on the backward
CHAIN_NAMES = ('planar_chain_batched', 'planar_chain_batched_bwd')


def _haar_stack(b: int, k: int, rng) -> np.ndarray:
    z = rng.normal(size=(b, k, k)) + 1j * rng.normal(size=(b, k, k))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=1, axis2=2)
    return q * (d / np.abs(d))[:, None, :]


def _chain_inputs(n: int, b: int, rng, dev):
    """The QML circuit's scheduled batched sequence at n (2 layers; at n=16
    its relabels, which the table folds) with Haar planes in place of its
    gates': per sample (b, K, K) where the QML step's planes are per sample,
    one (K, K) set expanded over the batch where they are one set."""
    import torch
    cir = qml_circuit(dev, n)
    data = torch.as_tensor(rng.random((b, n)), dtype=torch.float32, device=dev)
    mres, mims, wseq = cir._planar_seq_batched(
        cir._full_params(None, data, cir._data_indices(n)))
    out_r, out_i = [], []
    for m, ws in zip(mres, wseq):
        if ws[0] == 'rot':
            out_r.append(None)
            out_i.append(None)
            continue
        k = 1 << len(ws)
        us = _haar_stack(1 if m.stride(0) == 0 else b, k, rng)
        re = torch.as_tensor(us.real, dtype=torch.float32, device=dev).expand(b, k, k)
        im = torch.as_tensor(us.imag, dtype=torch.float32, device=dev).expand(b, k, k)
        out_r.append(re)
        out_i.append(im)
    return out_r, out_i, wseq


def _by_cluster(clusters: dict) -> str:
    return ', '.join(f'C={c}: device {v["device_ms"]:.4f} ms, {v["resident"]} clusters resident'
                     for c, v in clusters.items())


def check_batched_chain(results: dict, rng):
    """Phase 3, the batched gate chain (K1b / K6b redesigned): both entries
    of csrc/planar_chain_batched.cu at (n, B) = (14, 100), (12, 256), (16, 8)
    on the QML sequence with Haar planes (``_chain_inputs``), against the
    plain twin and against the per-step K1b (forward) and K1b + K5b + K1b /
    K6b (backward) on the same inputs. Bars as for the per-step kernels:
    states <= 1e-6 of max|ref| (backward 1e-5), planes <= 1e-5; dW bitwise
    equal over two launches; the inputs unwritten. Every shape's numbers are
    printed before a miss stops the run. Times: through the wrapper (CUDA
    events around the call), device time (the call's kernels behind a
    queued sleep), the per-step route both ways, the packing; the least
    cluster size that fits, the rule's (larger for a small batch) and twice
    the rule's, each with its device time and resident clusters."""
    import torch
    pg, pcb = _pkg()[1], _chain_mod()
    dev = torch.device('cuda')
    rows = {name: [] for name in CHAIN_NAMES}
    misses = []

    def hold(name, err, bar):
        if not err <= bar:
            misses.append(f'{name}: rel err {err} > {bar}')

    for n, b in CHAIN_SHAPES:
        label = f'n={n} B={b}'
        mres, mims, wseq = _chain_inputs(n, b, rng, dev)
        if not (pcb.batched_chain_ok(wseq, n, mres) and pcb.batched_chain_ok(wseq, n, mres, True)):
            raise AssertionError(f'batched chain {label}: the sequence does not qualify')
        ks = [len(ws) for ws in wseq if ws[0] != 'rot']
        n_rot = len(wseq) - len(ks)
        x = torch.as_tensor(rng.standard_normal((b, 2, 1 << n), dtype=np.float32), device=dev)
        g = torch.as_tensor(rng.standard_normal((b, 2, 1 << n), dtype=np.float32), device=dev)
        x0, g0 = x.clone(), g.clone()
        chain = pcb.pack_chain(x, mres, mims, n, wseq)
        n_per = sum(1 for r in chain.rows if not r[1])
        steps = (f'{len(ks)} gate steps (k=1: {ks.count(1)}, k=2: {ks.count(2)}, k=3: '
                 f'{ks.count(3)}; {n_per} with per-sample planes) and {n_rot} relabels folded')
        stack_bytes = b * 2 * (1 << n) * 4
        plane_bytes = 2 * 4 * (chain.ps_re.numel() * (chain.pstride > 0)
                               + chain.sh_re.numel() * (chain.sh_re.numel() > 1))
        flops = b * sum((1 << (n - k)) * 8 * 4 ** k for k in ks)

        # forward
        ref = pcb.planar_chain_batched_plain(x, chain)
        ref64 = pcb.planar_chain_batched_plain(x.double(), chain)
        y = pcb.planar_chain_batched(x, chain)
        y_steps = pg._steps_forward(x, mres, mims, n, wseq)
        torch.cuda.synchronize()
        e, d = rel_err(y, ref)
        e_steps = rel_err(y, y_steps)[0]
        e64, e64_steps = rel_err(y, ref64)[0], rel_err(y_steps, ref64)[0]
        hold(f'planar_chain_batched {label}', e, 1e-6)
        hold(f'planar_chain_batched {label} against the per-step K1b', e_steps, 1e-6)
        tk, _ = time_ms(lambda: pcb.planar_chain_batched(x, chain))
        t_dev = _queued_ms(lambda: pcb.planar_chain_batched(x, chain))
        t_pack, _ = time_ms(lambda: pcb.pack_chain(x, mres, mims, n, wseq))
        tp, _ = time_ms(lambda: pcb.planar_chain_batched_plain(x, chain), reps=5)
        ts, _ = time_ms(lambda: pg._steps_forward(x, mres, mims, n, wseq), reps=10)
        ts_dev = _queued_ms(lambda: pg._steps_forward(x, mres, mims, n, wseq), reps=10,
                            sleep_cycles=40_000_000)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        c_rule = 1 << pcb.cluster_bits(n, False, b, sms)
        clusters = {}
        for c in sorted({1 << pcb.cluster_bits(n), c_rule, min(8, 2 * c_rule)}):
            yc = pcb._planar_chain_batched_cuda(x, chain, cluster=c)
            torch.cuda.synchronize()
            if not torch.equal(yc, y):
                misses.append(f'planar_chain_batched {label}: cluster {c} differs from {c_rule}')
            clusters[c] = dict(device_ms=_queued_ms(
                lambda: pcb._planar_chain_batched_cuda(x, chain, cluster=c)),
                resident=pcb.max_active_clusters(n, False, c))
        bnd = bound(2 * stack_bytes + plane_bytes, flops)
        rows['planar_chain_batched'].append(dict(
            max_abs_err=d, rel_err=e, plane_rel_err=None, ms=tk, plain_ms=tp, library_ms=None,
            device_ms=t_dev, per_step_ms=ts, per_step_device_ms=ts_dev, pack_ms=t_pack,
            per_step_rel_err=e_steps, float64_rel_err=e64, cluster=c_rule, clusters=clusters,
            shape=f'n={n}, B={b}, {steps}', **bnd))
        print(f'planar_chain_batched {label} ({steps}): rel err {e:.2e} against the twin, '
              f'{e_steps:.2e} against the per-step K1b; against the float64 twin kernel {e64:.2e}, '
              f'per-step {e64_steps:.2e}; through the wrapper {tk:.4f} ms, device {t_dev:.4f} ms, '
              f'packing {t_pack:.4f} ms, twin {tp:.4f} ms, per-step route {ts:.4f} ms (device '
              f'{ts_dev:.4f} ms); bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]}, '
              f'{bnd["bound_ms"] / t_dev:.0%} of the device time); cluster size {c_rule} by the '
              f'rule; by cluster size '
              + _by_cluster(clusters))

        # backward from the twin's output
        y = ref
        y_in = y.clone()
        got = pcb.planar_chain_batched_bwd(y, g, chain)
        again = pcb.planar_chain_batched_bwd(y, g, chain)
        want = pcb.planar_chain_batched_plain(y, chain, g)
        steps_def = pg._steps_backward(y, g, mres, mims, n, wseq, False)
        steps_fus = pg._steps_backward(y, g, mres, mims, n, wseq, True)
        torch.cuda.synchronize()
        if not (torch.equal(y, y_in) and torch.equal(g, g0) and torch.equal(x, x0)):
            raise AssertionError(f'batched chain {label}: an input was written')
        gates = [i for i, ws in enumerate(wseq) if ws[0] != 'rot']
        if any(got[2][i] is None for i in gates) or any(a is not None for a, ws in zip(got[2], wseq)
                                                       if ws[0] == 'rot'):
            raise AssertionError(f'planar_chain_batched_bwd {label}: dW slots do not match the '
                                 'gates')
        eb = max(rel_err(got[0], want[0])[0], rel_err(got[1], want[1])[0])
        db = max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1])
        e_rec = rel_err(got[0], x)[0]
        pe = max(rel_err(got[j][i], want[j][i])[0] for j in (2, 3) for i in gates)
        pd = max(rel_err(got[j][i], want[j][i])[1] for j in (2, 3) for i in gates)
        e_vs = {}
        for route, (_, g_in, dres, dims) in (('K1b + K5b + K1b', steps_def), ('K6b', steps_fus)):
            e_vs[route] = (rel_err(got[1], g_in)[0],
                           max(rel_err(a[i], r[i])[0] for a, r in ((got[2], dres), (got[3], dims))
                               for i in gates))
        bitwise = all(torch.equal(a, c) for a, c in zip(got[:2], again[:2])) and all(
            torch.equal(got[j][i], again[j][i]) for j in (2, 3) for i in gates)
        hold(f'planar_chain_batched_bwd {label} states', eb, 1e-5)
        hold(f'planar_chain_batched_bwd {label} recovers x', e_rec, 1e-5)
        hold(f'planar_chain_batched_bwd {label} planes', pe, PLANE_BAR)
        for route, (es, ep) in e_vs.items():
            hold(f'planar_chain_batched_bwd {label} against {route}, states', es, 1e-5)
            hold(f'planar_chain_batched_bwd {label} against {route}, planes', ep, PLANE_BAR)
        if not bitwise:
            misses.append(f'planar_chain_batched_bwd {label}: two launches differ')
        tk, _ = time_ms(lambda: pcb.planar_chain_batched_bwd(y, g, chain))
        t_dev = _queued_ms(lambda: pcb.planar_chain_batched_bwd(y, g, chain))
        tp, _ = time_ms(lambda: pcb.planar_chain_batched_plain(y, chain, g), reps=5)
        per_step = {}
        for fused in (False, True):
            per_step['fused_bwd' if fused else 'default'] = dict(
                ms=time_ms(lambda: pg._steps_backward(y, g, mres, mims, n, wseq, fused),
                           reps=10)[0],
                device_ms=_queued_ms(lambda: pg._steps_backward(y, g, mres, mims, n, wseq, fused),
                                     reps=10, sleep_cycles=80_000_000))
        cb = 1 << pcb.cluster_bits(n, True, b, sms)
        clusters = {}
        for c in sorted({1 << pcb.cluster_bits(n, True), cb, min(8, 2 * cb)}):
            other = pcb._planar_chain_batched_bwd_cuda(y, g, chain, cluster=c)
            torch.cuda.synchronize()
            eo = max(rel_err(other[1], got[1])[0],
                     max(rel_err(other[j][i], got[j][i])[0] for j in (2, 3) for i in gates))
            hold(f'planar_chain_batched_bwd {label}: cluster {c} against {cb}', eo, 1e-5)
            clusters[c] = dict(device_ms=_queued_ms(
                lambda: pcb._planar_chain_batched_bwd_cuda(y, g, chain, cluster=c)),
                resident=pcb.max_active_clusters(n, True, c), rel_err=eo)
        dw_bytes = b * chain.fd * 4
        bnd = bound(4 * stack_bytes + plane_bytes + dw_bytes, 3 * flops)
        rows['planar_chain_batched_bwd'].append(dict(
            max_abs_err=max(db, pd), rel_err=eb, plane_rel_err=pe, ms=tk, plain_ms=tp,
            library_ms=None, device_ms=t_dev, per_step=per_step, recovers_x_rel_err=e_rec,
            per_step_rel_err=e_vs, cluster=cb, clusters=clusters, shape=f'n={n}, B={b}, {steps}',
            **bnd))
        print(f'planar_chain_batched_bwd {label}: state rel err {eb:.2e}, plane rel err {pe:.2e} '
              f'against the twin (x recovered to {e_rec:.2e}), against the per-step route '
              + ', '.join(f'{r} {es:.2e} / {ep:.2e}' for r, (es, ep) in e_vs.items())
              + f'; dW {"bitwise equal" if bitwise else "DIFFERENT"} over two launches; through '
              f'the wrapper {tk:.4f} ms, device {t_dev:.4f} ms, twin {tp:.4f} ms, per-step route '
              + ', '.join(f'{r} {v["ms"]:.4f} ms (device {v["device_ms"]:.4f})'
                          for r, v in per_step.items())
              + f'; bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]}, '
              f'{bnd["bound_ms"] / t_dev:.0%} of the device time); cluster size {cb} by the rule; '
              f'by cluster size '
              + _by_cluster(clusters))
        del x, g, y, ref, ref64, y_steps, got, again, want, steps_def, steps_fus
    for name, r in rows.items():
        results[name] = dict(r[0], other_shapes=r[1:])
    if misses:
        raise AssertionError('batched chain: ' + '; '.join(misses))


def check_window_kernels(results: dict, rng, rng_g):
    """Phase 3, the window kernels K2 (n=24) and K3, K4 (n=18)."""
    import torch
    _, _, wg, ck = _pkg()
    dev = torch.device('cuda')

    n = 24
    x = _randn_state(n, rng, dev)
    mre, mim = _planes(_haar(128, rng), dev)
    ref = wg.window_apply_plain(x, mre, mim, n, 7)
    y = wg.window_apply(x.clone(), mre, mim, n, 7)
    torch.cuda.synchronize()
    e, d = rel_err(y, ref)
    work = x.clone()
    tk, _ = time_ms(lambda: wg.window_apply(work, mre, mim, n, 7))
    tp, _ = time_ms(lambda: wg.window_apply_plain(x, mre, mim, n, 7))
    cols = 1 << (n - 7)
    # the library yardstick, used nowhere in the port: W as the real block
    # matrix [[Wr, -Wi], [Wi, Wr]] against the planes stacked as (256, cols)
    # is ONE float32 matmul with the same operation count
    block = torch.cat([torch.cat([mre, -mim], 1), torch.cat([mim, mre], 1)], 0)
    e_lib = rel_err(torch.matmul(block, x.view(256, cols)).view(2, -1), ref)[0]
    _hold('window_apply library call', e_lib, 1e-5)
    tl, _ = time_ms(lambda: torch.matmul(block, x.view(256, cols)))
    win_flops = 8 * 128 * 128               # a complex 128 x 128 product per column
    bnd = window_bounds(2 * 2 * (1 << n) * 4 + 2 * 128 * 128 * 4, cols * win_flops)
    results['window_apply'] = dict(max_abs_err=d, rel_err=e, plane_rel_err=None, ms=tk,
                                   plain_ms=tp, library_ms=tl, shape=f'n={n}', **bnd)
    print(f'window_apply n={n}: rel err {e:.2e}, kernel {tk:.4f} ms, twin {tp:.4f} ms, '
          f'one block matmul {tl:.4f} ms (rel err {e_lib:.2e}, kernel/matmul {tk / tl:.2f}), '
          f'{_shares(results["window_apply"])}')
    _hold('window_apply', e, 1e-6)
    del x, y, ref, work, block
    check_window_apply_sizes(results['window_apply'])

    n = 18
    cir = bench_circuit(n)
    mres, mims, wseq = cir._planar_seq(cir._full_params())
    if not ck.chain_fused_ok(wseq, n, mres):
        raise AssertionError('the n=18 bench sequence does not qualify for the window chain')
    n_win = sum(1 for s in wseq if s[0] == 'win')
    steps = f'{n_win} win + {len(wseq) - n_win} rot steps'
    cols = 1 << (n - 7)
    state_bytes = 2 * (1 << n) * 4
    stack_bytes = n_win * 2 * 128 * 128 * 4
    x = _randn_state(n, rng, dev)
    ref = ck.window_chain_plain(x, mres, mims, n, wseq)
    y = ck.window_chain_fwd(x, mres, mims, n, wseq)
    torch.cuda.synchronize()
    e, d = rel_err(y, ref)
    tk, _ = time_ms(lambda: ck.window_chain_fwd(x, mres, mims, n, wseq))
    tp, _ = time_ms(lambda: ck.window_chain_plain(x, mres, mims, n, wseq))
    bnd = window_bounds(2 * state_bytes + stack_bytes, n_win * cols * win_flops)
    rows = ck._merged_rows(ck._step_table(wseq, n)[0], n)
    # a barrier between two rows unless both are windows, none after the last
    barriers = sum(1 for a, b in zip(rows, rows[1:]) if not a[0] == b[0] == 1)
    t_dev = _device_ms(lambda: ck.window_chain_fwd(x, mres, mims, n, wseq), 'window_chain_fwd')
    results['window_chain_fwd'] = dict(max_abs_err=d, rel_err=e, plane_rel_err=None, ms=tk,
                                       plain_ms=tp, device_ms=t_dev, table_barriers=barriers,
                                       shape=f'n={n}, {len(wseq)} steps', **bnd)
    print(f'window_chain_fwd n={n} ({steps}; {len(rows)} table rows, so {barriers} grid '
          f'barriers): rel err {e:.2e}, kernel {tk:.4f} ms through the wrapper ({t_dev:.4f} ms '
          f'device time alone, profiler), twin {tp:.4f} ms, '
          f'{_shares(results["window_chain_fwd"])}')
    _hold('window_chain_fwd', e, 1e-5)

    # K4: y is the forward's output, g a random cotangent
    g = _randn_state(n, rng_g, dev)
    y0, g0 = y.clone(), g.clone()
    ref = ck.window_chain_bwd_plain(y, g, mres, mims, n, wseq)
    got = ck.window_chain_bwd(y, g, mres, mims, n, wseq)
    torch.cuda.synchronize()
    if not (torch.equal(y, y0) and torch.equal(g, g0)):
        raise AssertionError('window_chain_bwd wrote to its inputs')
    (e, d), (e2, d2) = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
    e, d = max(e, e2), max(d, d2)
    _hold('window_chain_bwd states', e, 1e-5)
    _hold('window_chain_bwd recovers x', rel_err(got[0], x)[0], 1e-5)
    pairs = [(a, b) for dk, dr in zip(got[2:], ref[2:]) for a, b in zip(dk, dr) if b is not None]
    if len(pairs) != 2 * n_win or any(a is None for a, _ in pairs):
        raise AssertionError('window_chain_bwd: dW slots do not match the window steps')
    pe, pd = max(rel_err(a, b) for a, b in pairs)
    _hold('window_chain_bwd dW', pe, PLANE_BAR)
    tk, _ = time_ms(lambda: ck.window_chain_bwd(y, g, mres, mims, n, wseq))
    tp, _ = time_ms(lambda: ck.window_chain_bwd_plain(y, g, mres, mims, n, wseq))
    # per window: W^H y and W^H g, and four real (128 x cols)(cols x 128) products
    dw_flops = 4 * 2 * 128 * 128 * cols
    bnd = window_bounds(4 * state_bytes + 2 * stack_bytes,
                        n_win * (2 * cols * win_flops + dw_flops))
    again = ck.window_chain_bwd(y, g, mres, mims, n, wseq)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for dk, dr in zip(got[2:], again[2:]) for a, b in zip(dk, dr)
               if a is not None):
        raise AssertionError('window_chain_bwd: two launches give different dW')
    rows = ck._merged_rows(ck._step_table(wseq, n, backward=True)[0], n)
    barriers = len(rows) - (rows[-1][0] == 0)
    t_dev = _device_ms(lambda: ck.window_chain_bwd(y, g, mres, mims, n, wseq), 'window_chain_bwd')
    results['window_chain_bwd'] = dict(max_abs_err=max(d, pd), rel_err=e, plane_rel_err=pe, ms=tk,
                                       plain_ms=tp, device_ms=t_dev, table_barriers=barriers,
                                       shape=f'n={n}, {len(wseq)} steps', **bnd)
    print(f'window_chain_bwd n={n} ({steps}; {len(rows)} table rows, so {barriers} grid barriers): '
          f'state rel err {e:.2e}, dW rel err {pe:.2e}, dW bitwise equal over two launches, '
          f'kernel {tk:.4f} ms through the wrapper ({t_dev:.4f} ms device time alone, profiler), '
          f'twin {tp:.4f} ms, {_shares(results["window_chain_bwd"])}')
    for n_other, sms in ((14, None), (19, None), (19, 114)):
        check_chain_size(n_other, sms)
    for name, rows in check_window_depth().items():
        results[name]['depth'] = rows


def check_window_apply_sizes(row: dict):
    """Phase 3, K2 at n = 12, 13, 16, 20, 24 with a random non-unitary W
    (its own generator, so that the other kernels' inputs stay as they
    were): in place, returns x, one launch each, <= 1e-6 of the twin."""
    import torch
    wg = _pkg()[2]
    dev = torch.device('cuda')
    rng = np.random.default_rng(SEED + 3)
    errs = {}
    for n in (12, 13, 16, 20, 24):
        w = (rng.standard_normal((128, 128)) + 1j * rng.standard_normal((128, 128))) / 16
        mre, mim = _planes(w, dev)
        x = _randn_state(n, rng, dev)
        ref = wg.window_apply_plain(x, mre, mim, n, 7)
        before = wg.window_apply.launches
        out = wg.window_apply(x, mre, mim, n, 7)
        torch.cuda.synchronize()
        if out is not x or wg.window_apply.launches != before + 1:
            raise AssertionError(f'window_apply n={n}: not in place, or not one launch')
        errs[n] = rel_err(x, ref)[0]
        print(f'window_apply n={n}, non-unitary W: rel err {errs[n]:.2e}')
    row['non_unitary_rel_err'] = errs
    for n, e in errs.items():
        _hold(f'window_apply n={n}, non-unitary W', e, 1e-6)


def _chain_sequence(n: int, layers: int):
    """The bench ansatz's window sequence at n (its windows and relabels;
    n=14's plan also has per-gate steps), as (mres, mims, wseq)."""
    ck = _pkg()[3]
    cir = bench_circuit(n, layers=layers)
    mres, mims, wseq = cir._planar_seq(cir._full_params())
    keep = [i for i, st in enumerate(wseq) if st[0] in ('win', 'rot')]
    mres, mims, wseq = [mres[i] for i in keep], [mims[i] for i in keep], tuple(wseq[i] for i in keep)
    if not ck.chain_fused_ok(wseq, n, mres):
        raise AssertionError(f'the n={n} bench sequence, {layers} layers, does not qualify')
    return mres, mims, wseq


def check_chain_size(n: int, sms=None):
    """Phase 3, K3 and K4 at another n on the bench sequence (2 layers; its
    windows and relabels): states and dW <= 1e-5 of the twin. With ``sms``
    the grid fills that many SMs only (114, an H100 PCIe's count, gives
    n=19's 128 column tiles to 114 blocks, so some blocks walk two tiles),
    and two launches of K4 must give bitwise-equal results."""
    import torch
    ck = _pkg()[3]
    dev = torch.device('cuda')
    mres, mims, wseq = _chain_sequence(n, 2)
    rng = np.random.default_rng(SEED + 4 + n)
    x = _randn_state(n, rng, dev)
    y = ck.window_chain_plain(x, mres, mims, n, wseq)
    g = _randn_state(n, rng, dev)
    ref = ck.window_chain_bwd_plain(y, g, mres, mims, n, wseq)
    if sms is None:
        fwd = ck.window_chain_fwd(x, mres, mims, n, wseq)
        got = ck.window_chain_bwd(y, g, mres, mims, n, wseq)
    else:
        if ck._bwd_slots(n, sms) <= sms:
            raise AssertionError(f'window chains n={n} on {sms} SMs: no block walks two tiles')
        fwd = ck._window_chain_fwd_cuda(x, mres, mims, n, wseq, sms=sms)
        got = ck._window_chain_bwd_cuda(y, g, mres, mims, n, wseq, sms=sms)
        again = ck._window_chain_bwd_cuda(y, g, mres, mims, n, wseq, sms=sms)
        if not all(torch.equal(a, b) for a, b in zip(got[:2] + tuple(got[2] + got[3]),
                                                      again[:2] + tuple(again[2] + again[3]))
                   if a is not None):
            raise AssertionError(f'window_chain_bwd n={n} on {sms} SMs: two launches differ')
    torch.cuda.synchronize()
    ef = rel_err(fwd, y)[0]
    e = max(rel_err(got[0], ref[0])[0], rel_err(got[1], ref[1])[0])
    pe = max(rel_err(a, b)[0] for dk, dr in zip(got[2:], ref[2:]) for a, b in zip(dk, dr)
             if b is not None)
    where = '' if sms is None else (f' on {sms} SMs, {ck._bwd_slots(n, sms)} column tiles')
    print(f'window_chain_fwd n={n} ({len(wseq)} steps{where}): rel err {ef:.2e}')
    print(f'window_chain_bwd n={n} ({len(wseq)} steps{where}'
          f'{"" if sms is None else ", bitwise equal over two launches"}): state rel err '
          f'{e:.2e}, dW rel err {pe:.2e}')
    _hold(f'window_chain_fwd n={n}{where}', ef, 1e-5)
    _hold(f'window_chain_bwd n={n}{where} states', e, 1e-5)
    _hold(f'window_chain_bwd n={n}{where} dW', pe, PLANE_BAR)


def _walk_window_apply(x, mres, mims, n: int, wseq):
    """The chain walked by K2 window by window, with the twin's relabels."""
    from deepquantum_tpu_torch.ops.planar_gate import _rotate_planar
    wg = _pkg()[2]
    x = x.clone()
    for mre, mim, st in zip(mres, mims, wseq):
        if st[0] == 'win':
            wg.window_apply(x, mre, mim, n, st[1])
        else:
            x = _rotate_planar(x, st[1], n)
    return x


def check_window_depth(n: int = 18, layer_counts=(10, 20)) -> dict:
    """Phase 3, the window kernels under depth: the bench ansatz's window
    sequence at n=18 with 10 and 20 layers, walked forward by K3, by K2
    window by window (the twin's relabels between), and backward by K4. Each
    against the float32 twin (states <= 1e-5, dW <= PLANE_BAR) and, with the
    twin, against the twin run in float64: the kernel's own error, <=
    DEPTH_BAR at the deepest walk and grown by at most DEPTH_RATIO from the
    shallower one (a bias that grows with the windows gives 2.0, rounding to
    nearest about sqrt(2)). A miss stops the run. Returns {kernel: [one row
    per layer count]}."""
    import torch
    ck = _pkg()[3]
    dev = torch.device('cuda')
    out = {'window_apply': [], 'window_chain_fwd': [], 'window_chain_bwd': []}

    def errs(a, b):
        return max(rel_err(p.double(), q.double())[0] for p, q in zip(a, b) if q is not None)

    for layers in layer_counts:
        mres, mims, wseq = _chain_sequence(n, layers)
        n_win = sum(1 for st in wseq if st[0] == 'win')
        d64 = [[None if m is None else m.double() for m in ms] for ms in (mres, mims)]
        rng = np.random.default_rng(SEED + 40 + layers)
        x = _randn_state(n, rng, dev)
        y = ck.window_chain_plain(x, mres, mims, n, wseq)
        g = _randn_state(n, rng, dev)
        y64 = ck.window_chain_plain(x.double(), *d64, n, wseq)
        walks = {'window_chain_fwd': ck.window_chain_fwd(x, mres, mims, n, wseq),
                 'window_apply': _walk_window_apply(x, mres, mims, n, wseq)}
        got = ck.window_chain_bwd(y, g, mres, mims, n, wseq)
        ref = ck.window_chain_bwd_plain(y, g, mres, mims, n, wseq)
        exact = ck.window_chain_bwd_plain(y.double(), g.double(), *d64, n, wseq)
        torch.cuda.synchronize()
        for name, st in walks.items():
            if not torch.isfinite(st).all():
                raise AssertionError(f'{name} n={n}, {layers} layers: non-finite output')
            out[name].append(dict(layers=layers, windows=n_win, state_rel_err=errs([st], [y]),
                                  kernel_vs_float64=[errs([st], [y64])],
                                  twin_vs_float64=[errs([y], [y64])]))
        if not all(torch.isfinite(t).all() for t in got[:2]):
            raise AssertionError(f'window_chain_bwd n={n}, {layers} layers: non-finite output')
        out['window_chain_bwd'].append(dict(
            layers=layers, windows=n_win, state_rel_err=errs(got[:2], ref[:2]),
            dw_rel_err=errs(got[2] + got[3], ref[2] + ref[3]),
            kernel_vs_float64=[errs(got[:2], exact[:2]), errs(got[2] + got[3], exact[2] + exact[3])],
            twin_vs_float64=[errs(ref[:2], exact[:2]), errs(ref[2] + ref[3], exact[2] + exact[3])]))
    for name, rows in out.items():
        first, last = rows[0], rows[-1]
        for r in rows:
            r['holds_bar'] = r['state_rel_err'] <= 1e-5 and r.get('dw_rel_err', 0) <= PLANE_BAR
        growth = [b / a for a, b in zip(first['kernel_vs_float64'], last['kernel_vs_float64'])]
        last['growth'] = dict(from_layers=first['layers'], factor=growth)
        last['holds_depth_bar'] = max(last['kernel_vs_float64']) <= DEPTH_BAR \
            and max(growth) <= DEPTH_RATIO
        for r in rows:
            what = 'states / dW' if 'dw_rel_err' in r else 'states'
            twin = [r['state_rel_err']] + ([r['dw_rel_err']] if 'dw_rel_err' in r else [])
            print(f'{name} n={n}, {r["layers"]} layers ({r["windows"]} windows): {what} against '
                  f'the twin {" / ".join(f"{v:.2e}" for v in twin)} (bar 1e-5: '
                  f'{"holds" if r["holds_bar"] else "FAILS"}); against the float64 twin: kernel '
                  f'{" / ".join(f"{v:.2e}" for v in r["kernel_vs_float64"])}, float32 twin '
                  f'{" / ".join(f"{v:.2e}" for v in r["twin_vs_float64"])}')
        print(f'{name} n={n}: kernel error against float64 grew x'
              f'{" / ".join(f"{v:.2f}" for v in growth)} from {first["layers"]} to '
              f'{last["layers"]} layers (bars: {DEPTH_BAR:.0e} at {last["layers"]}, '
              f'x{DEPTH_RATIO}: {"holds" if last["holds_depth_bar"] else "FAILS"})')
    for name, rows in out.items():
        for r in rows:
            _hold(f'{name} n={n}, {r["layers"]} layers, states', r['state_rel_err'], 1e-5)
            if 'dw_rel_err' in r:
                _hold(f'{name} n={n}, {r["layers"]} layers, dW', r['dw_rel_err'], PLANE_BAR)
        last = rows[-1]
        if not last['holds_depth_bar']:
            raise AssertionError(f'{name} n={n}: against float64 '
                                 f'{last["kernel_vs_float64"]} at {last["layers"]} layers, '
                                 f'growth {last["growth"]}; bars {DEPTH_BAR}, x{DEPTH_RATIO}')
    return out


def _device_ms(fn, name: str, calls: int = 5) -> float:
    """Device time per call of the kernels whose name holds ``name``, from
    one torch.profiler window of ``calls`` calls after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    ms = sum(k['ms_per_step'] for k in _device_profile(fn, calls)['port_kernels']
             if name in k['name'])
    if ms <= 0:
        raise AssertionError(f'the profiler saw no device time of {name}')
    return ms


def _queued_ms(fn, reps: int = REPS, sleep_cycles: int = 2_000_000) -> float:
    """Device time of one fn() call: CUDA events around it while a sleep
    kernel queued just before keeps the card busy, so the host's enqueue
    hides behind it and the events time fn's kernels back to back, the gaps
    between them included; the median of ``reps``. Used where a call is
    many small launches, in place of a profiler window per row (a window
    has come back without any device operation on the card). A call whose
    enqueue takes longer asks for more ``sleep_cycles``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(sleep_cycles)       # 2M: ~1 ms of device time, longer than the enqueue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _cold_ms(fn, reps: int = REPS, sleep_cycles: int = 2_000_000) -> float:
    """``_queued_ms`` with the L2 flushed before each call: a read of 128 MB
    (the card's L2 holds 50 MB) queued between the sleep and fn, so fn
    finds its inputs in device memory. The median of ``reps``."""
    import torch
    flush = torch.empty(32 << 20, dtype=torch.float32, device='cuda')
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(sleep_cycles)
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# the host calls through which a device operation is issued
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cudaLaunchCooperativeKernel',
                'cuLaunchKernel', 'cuLaunchKernelEx', 'cudaMemsetAsync', 'cudaMemcpyAsync',
                'cudaMemcpy2DAsync')


def check_one_launch(fn, calls: int, label: str, kernel: str = 'planar_grad_kernel',
                     tries: int = 3):
    """``calls`` calls of fn issue ``calls`` device operations, every one the
    ``kernel`` named: the sum over blocks ends in the same launch, with no
    reduction op after it. A profiler window counts the host's launch calls
    (every device operation is issued through one of LAUNCH_CALLS) and the
    device's records, which must all be the kernel's and no more than the
    calls. The device side alone is no count: on the card a window has come
    back with no record, or one short, of a kernel of a few microseconds
    while the host had issued every launch. A window with no host launch
    call at all is tried again, ``tries`` times."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        ops = [(ev.key, ev.count) for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        launches = [(ev.key, ev.count) for ev in events if ev.key in LAUNCH_CALLS]
        if launches:
            break
    n_ops = sum(c for _, c in ops)
    n_launch = sum(c for _, c in launches)
    if n_launch != calls or n_ops > calls or not all(kernel in key for key, _ in ops):
        raise AssertionError(f'{label}: {calls} calls gave host launches {launches}, device ops '
                             f'{ops}')
    print(f'{label}: {calls} calls, {n_launch} device operations issued ({launches}), '
          f'{n_ops} recorded on the device: {[k[:72] for k, _ in ops]}')


def check_slice(n: int, extra_cnot, expect):
    """Phases 4-5: forward + expectation through the public API on the card.
    ``expect(counts)`` checks the kernel launch counts of one run."""
    import torch
    dqt = _pkg()[0]
    label = f'n={n}' + (f' + cnot{extra_cnot}/layer' if extra_cnot else '')
    dqt.set_dtype('complex64')
    cir = bench_circuit(n, None, extra_cnot)
    if cir.device.type != 'cuda':
        raise AssertionError(f'{label}: the circuit landed on {cir.device}')
    with torch.inference_mode():
        reset_counts()
        state = cir.forward()
        e = cir.expectation()
        torch.cuda.synchronize()
        counts = read_counts()
        state = state.clone()
    print(f'slice {label}: launches {counts}')
    expect(counts)

    dqt.set_dtype('complex128')
    try:
        ref_cir = bench_circuit(n, 'cuda', extra_cnot)
        if ref_cir._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        with torch.inference_mode():
            ref_state = ref_cir.forward()
            ref_e = ref_cir.expectation()
    finally:
        dqt.set_dtype('complex64')
    if not (torch.isfinite(state.real).all() and torch.isfinite(state.imag).all()):
        raise AssertionError(f'{label}: non-finite state')
    if tuple(state.shape) != (1 << n, 1) or tuple(e.shape) != (1,):
        raise AssertionError(f'{label}: shapes {tuple(state.shape)}, {tuple(e.shape)}')
    d_state = (state.to(torch.complex128) - ref_state).abs().max().item()
    d_e = abs(e.item() - ref_e.item())
    print(f'slice {label}: <X..X> = {e.item():.8f} (complex128 {ref_e.item():.8f}), '
          f'|d exp| {d_e:.2e}, state max|d| {d_state:.2e}')
    if not (d_e <= 1e-5 and d_state <= 1e-5):
        raise AssertionError(f'{label}: differs from the complex128 route')

    def step():
        cir.forward()
        cir.expectation()

    with torch.inference_mode():
        t_kernel, _ = time_ms(step)
        reset_counts()
        with twin_route():
            t_twin, _ = time_ms(step)
            e_twin = cir.expectation().item()
        if sum(read_counts().values()) != 0:
            raise AssertionError('the twin route launched a kernel')
    if abs(e_twin - e.item()) > 1e-5:
        raise AssertionError(f'{label}: twin route gives {e_twin}, kernel route {e.item()}')
    print(f'slice {label}: forward + expectation median over {REPS} calls: kernel route '
          f'{t_kernel:.3f} ms, twin route {t_twin:.3f} ms')
    return counts, t_kernel, t_twin


def grad_step(cir, p, update: bool = True):
    """One training step: forward, expectation, backward and, with
    ``update``, the SGD update in place. Returns (loss, gradient)."""
    import torch
    loss = cir.expectation(params=p)[0]
    loss.backward()
    grad, p.grad = p.grad, None
    if update:
        with torch.no_grad():
            p -= LR * grad
    return loss.detach(), grad


_REFERENCES: dict = {}


def _reference_grad(n: int, extra_cnot, layers: int, sgd_steps: int = 0):
    """Loss and gradient on the port's complex128 einsum route with plain
    autograd on the card, then the losses of ``sgd_steps`` SGD steps (each
    step's loss, and the loss after the last update). Made once per
    arguments: phases 6 and 9e hold the same circuit to it."""
    key = (n, extra_cnot, layers, sgd_steps)
    if key not in _REFERENCES:
        _REFERENCES[key] = _reference_grad_uncached(n, extra_cnot, layers, sgd_steps)
    return _REFERENCES[key]


def _reference_grad_uncached(n: int, extra_cnot, layers: int, sgd_steps: int):
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex128')
    try:
        cir = bench_circuit(n, 'cuda', extra_cnot, layers)
        if cir._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        p = cir.params.requires_grad_()
        loss, grad = grad_step(cir, p, update=False)
        losses = []
        for _ in range(sgd_steps):
            losses.append(grad_step(cir, p)[0].item())
        if sgd_steps:
            with torch.no_grad():
                losses.append(cir.expectation(params=p)[0].item())
        torch.cuda.synchronize()
        return loss.item(), grad, losses
    finally:
        dqt.set_dtype('complex64')


def check_training(n: int = 18):
    """Phase 6: the VQE gradient step at n=18, 5 layers, full width."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    cir = bench_circuit(n)
    if cir.device.type != 'cuda' or not cir._planar_ok():
        raise AssertionError(f'training n={n}: device {cir.device}, planar {cir._planar_ok()}')
    p0 = cir.params
    if p0.device.type != 'cuda':
        raise AssertionError(f'training n={n}: parameters on {p0.device}')

    p = p0.clone().requires_grad_()
    reset_counts()
    loss, grad = grad_step(cir, p, update=False)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f'training n={n}: launches per grad step {counts}')
    if counts['window_chain_fwd'] != 2 or counts['window_chain_bwd'] != 1:
        raise AssertionError(f'training n={n}: expected window_chain_fwd 2 and window_chain_bwd 1')
    if tuple(grad.shape) != tuple(p0.shape) or not torch.isfinite(grad).all():
        raise AssertionError(f'training n={n}: gradient shape {tuple(grad.shape)} or non-finite')

    ref_loss, ref_grad, ref_losses = _reference_grad(n, None, LAYERS, sgd_steps=3)
    d_loss = abs(loss.item() - ref_loss)
    d_grad = (grad.double() - ref_grad).abs().max().item()
    print(f'training n={n}: loss {loss.item():.8f} (complex128 {ref_loss:.8f}), |d loss| '
          f'{d_loss:.2e}, max|d grad| {d_grad:.2e} (max|grad| {ref_grad.abs().max().item():.3e})')
    if not (d_loss <= 1e-5 and d_grad <= 1e-4):
        raise AssertionError(f'training n={n}: differs from the complex128 route')

    p = p0.clone().requires_grad_()
    losses = [grad_step(cir, p)[0].item() for _ in range(3)]
    with torch.no_grad():
        losses.append(cir.expectation(params=p)[0].item())
    d_sgd = max(abs(a - b) for a, b in zip(losses, ref_losses))
    print(f'training n={n}: 3 SGD steps, losses {[round(v, 8) for v in losses]}, '
          f'max |d| to complex128 {d_sgd:.2e}')
    if not d_sgd <= 1e-5:
        raise AssertionError(f'training n={n}: the SGD losses drift from the complex128 route')

    p = p0.clone().requires_grad_()
    t_kernel, _ = time_ms(lambda: grad_step(cir, p))
    p = p0.clone().requires_grad_()
    reset_counts()
    with twin_route():
        t_twin, _ = time_ms(lambda: grad_step(cir, p))
    if sum(read_counts().values()) != 0:
        raise AssertionError('the twin route launched a kernel')
    print(f'training n={n}: grad step (forward, expectation, backward, update) median over '
          f'{REPS} steps: kernel route {t_kernel:.3f} ms, twin route {t_twin:.3f} ms')
    return counts, t_kernel, t_twin


def check_step_backward(n: int = 22, extra_cnot=(0, 11), layers: int = 2, reps: int = 5):
    """Phase 7: the per-step backward walk, default and fused."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    label = f'n={n} + cnot{extra_cnot}/layer, {layers} layers'
    ref_loss, ref_grad, _ = _reference_grad(n, extra_cnot, layers)
    out = {}
    for fused in (False, True):
        cir = bench_circuit(n, None, extra_cnot, layers)
        cir.fused_bwd = fused
        p = cir.params.requires_grad_()
        reset_counts()
        loss, grad = grad_step(cir, p, update=False)
        torch.cuda.synchronize()
        counts = read_counts()
        d_loss = abs(loss.item() - ref_loss)
        d_grad = (grad.double() - ref_grad).abs().max().item()
        t, _ = time_ms(lambda: grad_step(cir, p), reps=reps, warmup=1)
        print(f'backward {label}, fused_bwd={fused}: launches {counts}, |d loss| {d_loss:.2e}, '
              f'max|d grad| {d_grad:.2e}, grad step median over {reps}: {t:.3f} ms')
        if not (d_loss <= 1e-5 and d_grad <= 1e-4):
            raise AssertionError(f'{label}, fused_bwd={fused}: differs from the complex128 route')
        out[fused] = (counts, grad, t)
    c_def, c_fus = out[False][0], out[True][0]
    if c_def['planar_grad'] < 2 or c_def['planar_apply'] <= 0 or c_def['window_apply'] <= 0 \
            or c_def['planar_bwd_fused'] != 0:
        raise AssertionError(f'{label}: default backward launches {c_def}')
    if c_fus['planar_bwd_fused'] < 2 or c_fus['planar_grad'] != 0:
        raise AssertionError(f'{label}: fused backward launches {c_fus}')
    d = (out[False][1] - out[True][1]).abs().max().item()
    print(f'backward {label}: default vs fused max|d grad| {d:.2e}')
    if not d <= 1e-5:
        raise AssertionError(f'{label}: default and fused gradients differ by {d}')
    cir = bench_circuit(n, None, extra_cnot, layers)
    p = cir.params.requires_grad_()
    reset_counts()
    with twin_route():
        t_twin, _ = time_ms(lambda: grad_step(cir, p), reps=reps, warmup=1)
    if sum(read_counts().values()) != 0:
        raise AssertionError('the twin route launched a kernel')
    print(f'backward {label}: grad step median over {reps}: kernel route {out[False][2]:.3f} ms, '
          f'twin route {t_twin:.3f} ms')
    return c_def, c_fus


# ------------------------------------------------------------ batched QML
QML_N, QML_LAYERS, QML_B = 14, 2, 100     # bench_suite.py::bench_batched_qml


def qml_circuit(device=None, n: int = QML_N):
    """bench_batched_qml's circuit (benchmarks/bench_suite.py:693-755):
    QML_LAYERS x (ry(encode) on every wire; rz, ry on every wire; CNOT
    ring), observable Z on wire 0, reupload: the 14 features of a sample
    wrap around the 28 encoders (``n`` other than 14: the same ansatz on n
    wires). With no device it lands on the card."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(n, device=device, reupload=True)
    for _ in range(QML_LAYERS):
        for i in range(n):
            cir.ry(i, encode=True)
        for i in range(n):
            cir.rz(i)
            cir.ry(i)
        cir.cnot_ring()
    cir.observable(0)
    cir.init_para(SEED)
    return cir


def qml_inputs(device, n: int = QML_N, batch: int = QML_B):
    """The benchmark's data, (100, 14) float32 from default_rng(0), and the
    hybrid variant's linear layer W (14 x 14) and b from default_rng(SEED)
    (or (batch, n), (n, n) and n)."""
    import torch
    data = np.random.default_rng(0).random((batch, n)).astype(np.float32)
    rng = np.random.default_rng(SEED)
    w = rng.normal(0, 0.5, (n, n)).astype(np.float32)
    b = rng.normal(0, 0.1, n).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (data, w, b)]


def qml_step(cir, leaves, hybrid: bool, update: bool = True):
    """One data-encoded training step: expectation(data=feats, params=p) of
    shape (B, 1), the mean as the loss, backward, and with ``update`` the SGD
    update of every leaf in place. leaves = [p, data, W, b]; the hybrid
    variant feeds feats = data @ W + b, so the gradient also reaches W and b.
    Returns (loss, gradients of the leaves that train)."""
    import torch
    p, data, w, b = leaves
    feats = data @ w + b if hybrid else data
    out = cir.expectation(data=feats, params=p)
    if tuple(out.shape) != (data.shape[0], 1):
        raise AssertionError(f'batched expectation of shape {tuple(out.shape)}')
    loss = out.mean()
    loss.backward()
    train = [p, w, b] if hybrid else [p]
    grads = []
    for t in train:
        grads.append(t.grad)
        t.grad = None
    if update:
        with torch.no_grad():
            for t, gr in zip(train, grads):
                t -= LR * gr
    return loss.detach(), grads


def _qml_leaves(cir, device, hybrid: bool, batch: int = QML_B):
    dqt = _pkg()[0]
    data, w, b = qml_inputs(device, cir.nqubit, batch)
    p = cir.params.to(dqt.rdtype()).requires_grad_()
    if hybrid:
        w, b = w.to(dqt.rdtype()).requires_grad_(), b.to(dqt.rdtype()).requires_grad_()
    return [p, data.to(dqt.rdtype()), w.to(dqt.rdtype()), b.to(dqt.rdtype())]


def _qml_reference(hybrid: bool, sgd_steps: int = 3, n: int = QML_N, batch: int = QML_B):
    """Loss and gradients on the port's complex128 einsum route on the
    card, then the losses of ``sgd_steps`` SGD steps."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex128')
    try:
        cir = qml_circuit('cuda', n)
        if cir._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        leaves = _qml_leaves(cir, 'cuda', hybrid, batch)
        loss, grads = qml_step(cir, leaves, hybrid, update=False)
        losses = [qml_step(cir, leaves, hybrid)[0].item() for _ in range(sgd_steps)]
        with torch.no_grad():
            losses.append(qml_step_loss(cir, leaves, hybrid))
        torch.cuda.synchronize()
        return loss.item(), grads, losses
    finally:
        dqt.set_dtype('complex64')


def qml_step_loss(cir, leaves, hybrid: bool) -> float:
    p, data, w, b = leaves
    return cir.expectation(data=data @ w + b if hybrid else data, params=p).mean().item()


@contextlib.contextmanager
def per_step_route():
    """Run a batched gate chain step by step, as outside the batched-chain
    range (the per-step K1b forward; K1b + K5b + K1b or K6b backward): the
    planar engine's packing of the one-launch chain gives nothing."""
    pg = _pkg()[1]
    saved = pg._batched_chain
    pg._batched_chain = lambda *args, **kwargs: None
    try:
        yield
    finally:
        pg._batched_chain = saved


@contextlib.contextmanager
def expectation_launches(out: list):
    """Count in out[0] the forward-chain launches made inside
    planar_pauli_expectation (the observable's own one-step chain)."""
    pg, pcb = _pkg()[1], _chain_mod()
    saved = pg.planar_pauli_expectation

    def counted(*args, **kwargs):
        before = pcb.planar_chain_batched.launches
        value = saved(*args, **kwargs)
        out[0] += pcb.planar_chain_batched.launches - before
        return value

    pg.planar_pauli_expectation = counted
    try:
        yield
    finally:
        pg.planar_pauli_expectation = saved


def check_batched_qml(card: str, reps: int = 10):
    """The batched QML slice: bench_batched_qml's circuit at n=14, 2 layers,
    B=100 through the public API on the card, plain and hybrid. Per step,
    default and fused_bwd alike: one planar_chain_batched launch for the
    gate chain, one more for the expectation's own one-step chain (counted
    apart), one planar_chain_batched_bwd launch, and no per-step K1b / K5b /
    K6b, window or window-chain kernel; loss and gradients against the
    complex128 route (<= 1e-5, <= 1e-4), fused against default (<= 1e-5),
    three SGD steps on the kernel and twin routes (losses <= 1e-5 apart
    after each); the step medians on the kernel route, the per-step route
    (``per_step_route``) and the twin route in turns, and the device's busy
    share in a profiler window."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    no_launch = ('window_apply', 'window_chain_fwd', 'window_chain_bwd') + PLANAR_BATCHED
    main_counts, out = {name: 0 for name in KERNELS}, {}
    for hybrid in (False, True):
        label = f'batched QML n={QML_N}, {QML_LAYERS} layers, B={QML_B}' + \
            (', hybrid' if hybrid else '')
        ref_loss, ref_grads, ref_losses = _qml_reference(hybrid)
        grads_by_route = {}
        for fused in (False, True):
            cir = qml_circuit()
            cir.fused_bwd = fused
            if cir.device.type != 'cuda' or not cir._planar_ok():
                raise AssertionError(f'{label}: device {cir.device}, planar {cir._planar_ok()}')
            leaves = _qml_leaves(cir, cir.device, hybrid)
            reset_counts()
            in_exp = [0]
            with expectation_launches(in_exp):
                loss, grads = qml_step(cir, leaves, hybrid, update=False)
            torch.cuda.synchronize()
            counts = read_counts()
            d_loss = abs(loss.item() - ref_loss)
            d_grad = max((a.double() - r).abs().max().item() for a, r in zip(grads, ref_grads))
            print(f'{label}, fused_bwd={fused}: launches {counts} (of planar_chain_batched, '
                  f'{in_exp[0]} in the expectation\'s chain), loss {loss.item():.8f} (complex128 '
                  f'{ref_loss:.8f}), |d loss| {d_loss:.2e}, max|d grad| {d_grad:.2e} over '
                  f'{"p, W, b" if hybrid else "p"}')
            if any(counts[k] for k in no_launch):
                raise AssertionError(f'{label}: a per-step, window or window-chain kernel was '
                                     'launched')
            if (counts['planar_chain_batched'] - in_exp[0], in_exp[0],
                    counts['planar_chain_batched_bwd']) != (1, 1, 1):
                raise AssertionError(f'{label}, fused_bwd={fused}: expected one forward-chain '
                                     'launch for the gates, one for the expectation and one '
                                     f'backward-chain launch, got {counts}')
            if not (d_loss <= 1e-5 and d_grad <= 1e-4):
                raise AssertionError(f'{label}, fused_bwd={fused}: differs from complex128')
            grads_by_route[fused] = grads
            for name, c in counts.items():
                main_counts[name] += c
        d = max((a - b).abs().max().item() for a, b in zip(*grads_by_route.values()))
        print(f'{label}: default vs fused_bwd max|d grad| {d:.2e}')
        if not d <= 1e-5:
            raise AssertionError(f'{label}: default and fused gradients differ by {d}')

        cir = qml_circuit()
        leaves = _qml_leaves(cir, cir.device, hybrid)
        losses = [qml_step(cir, leaves, hybrid)[0].item() for _ in range(3)]
        with torch.no_grad():
            losses.append(qml_step_loss(cir, leaves, hybrid))
        reset_counts()
        with twin_route():
            twin_leaves = _qml_leaves(cir, cir.device, hybrid)
            twin = [qml_step(cir, twin_leaves, hybrid)[0].item() for _ in range(3)]
            with torch.no_grad():
                twin.append(qml_step_loss(cir, twin_leaves, hybrid))
        if sum(read_counts().values()) != 0:
            raise AssertionError('the twin route launched a kernel')
        d_twin = max(abs(a - b) for a, b in zip(losses, twin))
        d_ref = max(abs(a - b) for a, b in zip(losses, ref_losses))
        print(f'{label}: 3 SGD steps, losses {[round(v, 8) for v in losses]}, max |d| to the twin '
              f'route {d_twin:.2e}, to complex128 {d_ref:.2e}')
        if not (d_twin <= 1e-5 and d_ref <= 1e-5):
            raise AssertionError(f'{label}: the SGD losses drift between routes')

        reset_counts()
        with per_step_route():
            qml_step(cir, _qml_leaves(cir, cir.device, hybrid), hybrid)
        torch.cuda.synchronize()
        steps = read_counts()
        if steps['planar_chain_batched'] or steps['planar_chain_batched_bwd'] \
                or steps['planar_apply_batched'] < 1 or steps['planar_grad_batched'] < 1:
            raise AssertionError(f'{label}: the per-step route launched {steps}')
        routes = {'kernel': contextlib.nullcontext, 'per_step': per_step_route,
                  'twin': twin_route}
        leaves = {r: _qml_leaves(cir, cir.device, hybrid) for r in routes}
        times = {r: [] for r in routes}
        for r in ('kernel', 'per_step', 'twin', 'twin', 'per_step', 'kernel'):
            with routes[r]():
                times[r] += time_ms(lambda: qml_step(cir, leaves[r], hybrid), reps=reps // 2,
                                    warmup=1)[1]
        t = {r: float(np.median(v)) for r, v in times.items()}
        dev = _device_profile(lambda: qml_step(cir, leaves['kernel'], hybrid), 3)
        busy = dev['device_ms_per_step'] / t['kernel']
        print(f'{label}: step median over {len(times["kernel"])} (in turns: kernel, per-step, '
              f'twin, twin, per-step, kernel): kernel route {t["kernel"]:.3f} ms, per-step route '
              f'{t["per_step"]:.3f} ms ({sum(steps.values())} launches a step), twin route '
              f'{t["twin"]:.3f} ms; device {dev["device_ms_per_step"]:.3f} ms per step '
              f'({dev["device_ops_per_step"]:.0f} device ops, busy {busy:.1%}), top '
              f'{[(k["name"][:40], round(k["ms_per_step"], 4)) for k in dev["top_kernels"][:4]]} '
              f'[{card}]')
        out['hybrid' if hybrid else 'plain'] = dict(
            step_ms=t['kernel'], per_step_step_ms=t['per_step'], twin_step_ms=t['twin'],
            per_step_launches=steps, device_busy_share=busy)
    return main_counts, out


def check_batched_qml_wide(n: int = 18, batch: int = 8):
    """The batched QML step outside the batched-chain range (n=18 > 17):
    bench_batched_qml's ansatz on 18 wires, 2 layers, B=8, plain, through
    the public API. The per-step batched kernels carry it: K1b and K5b per
    gate step (K6b instead of K5b with fused_bwd), no chain kernel; loss and
    gradient against the complex128 route (<= 1e-5, <= 1e-4), fused against
    default (<= 1e-5)."""
    import torch
    label = f'batched QML n={n}, {QML_LAYERS} layers, B={batch} (outside the chain range)'
    ref_loss, ref_grads, _ = _qml_reference(False, 0, n, batch)
    main_counts, grads = {name: 0 for name in KERNELS}, {}
    for fused in (False, True):
        cir = qml_circuit(None, n)
        cir.fused_bwd = fused
        leaves = _qml_leaves(cir, cir.device, False, batch)
        reset_counts()
        loss, grads[fused] = qml_step(cir, leaves, False, update=False)
        torch.cuda.synchronize()
        counts = read_counts()
        d_loss = abs(loss.item() - ref_loss)
        d_grad = (grads[fused][0].double() - ref_grads[0]).abs().max().item()
        print(f'{label}, fused_bwd={fused}: launches {counts}, |d loss| {d_loss:.2e}, '
              f'max|d grad| {d_grad:.2e}')
        if counts['planar_chain_batched'] or counts['planar_chain_batched_bwd'] \
                or counts['planar_apply_batched'] < 1 \
                or counts['planar_bwd_fused_batched' if fused else 'planar_grad_batched'] < 1 \
                or counts['planar_grad_batched' if fused else 'planar_bwd_fused_batched']:
            raise AssertionError(f'{label}, fused_bwd={fused}: launches {counts}')
        if not (d_loss <= 1e-5 and d_grad <= 1e-4):
            raise AssertionError(f'{label}, fused_bwd={fused}: differs from complex128')
        for name, c in counts.items():
            main_counts[name] += c
    d = (grads[False][0] - grads[True][0]).abs().max().item()
    print(f'{label}: default vs fused_bwd max|d grad| {d:.2e}')
    if not d <= 1e-5:
        raise AssertionError(f'{label}: default and fused gradients differ by {d}')
    return main_counts


# --------------------------------------------------- noisy circuits (den_mat)
DM_LAYERS, DM_THETA = 3, 0.01         # bench_suite.py::bench_denmat
DM_STEPS = 10
DMQ_N, DMQ_B = 8, 16                   # the batched noisy QML step
MEASURE_SHOTS = 10 ** 6


def noisy_circuit(n: int, device=None):
    """bench_denmat's circuit (benchmarks/bench_suite.py:761-815): a density
    matrix on n qubits, DM_LAYERS x (rx, rz on every wire; CNOT ring;
    depolarizing(0, inputs=0.01)), X string on all wires; init_para(SEED).
    With no device it lands on the card."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(n, den_mat=True, device=device)
    for _ in range(DM_LAYERS):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
        cir.cnot_ring()
        cir.depolarizing(0, inputs=DM_THETA)
    cir.observable(list(range(n)), basis='x' * n)
    cir.init_para(SEED)
    return cir


def noisy_qml_circuit(device=None, n: int = DMQ_N):
    """tests/test_planar.py's batched density-matrix circuit: ry(encode) on
    every wire, rz on every wire, a CNOT ring, depolarizing(0, inputs=0.02),
    rx on every wire; Z on wire 0 and X Z on wires 1, 2."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(n, den_mat=True, device=device)
    for i in range(n):
        cir.ry(i, encode=True)
    for i in range(n):
        cir.rz(i)
    cir.cnot_ring()
    cir.depolarizing(0, inputs=0.02)
    for i in range(n):
        cir.rx(i)
    cir.observable(0)
    cir.observable([1, 2], basis='xz')
    cir.init_para(SEED)
    return cir


def _noisy_qml_step(cir, p, data):
    """The batched noisy step: expectation(data, params=p) (B, 2), the mean
    as the loss, backward. Returns (loss, gradient); p is not updated."""
    loss = cir.expectation(data=data, params=p).mean()
    loss.backward()
    grad, p.grad = p.grad, None
    return loss.detach(), grad


def _in_turns(step, reps: int) -> dict:
    """Medians of ``step`` on the kernel and twin routes, timed in turns
    (kernel, twin, twin, kernel), ``reps`` steps each in all."""
    times = {'kernel': [], 'twin': []}
    for r in ('kernel', 'twin', 'twin', 'kernel'):
        reset_counts()
        with (twin_route() if r == 'twin' else contextlib.nullcontext()):
            times[r] += time_ms(step, reps=reps // 2, warmup=0 if times[r] else 1)[1]
        if r == 'twin' and sum(read_counts().values()) != 0:
            raise AssertionError('the twin route launched a kernel')
    return {r: float(np.median(v)) for r, v in times.items()}


def check_noisy_step(card: str, n: int):
    """The noisy grad step (bench_denmat's circuit, rho a 2n-wire planar
    state; three depolarizing superoperators between the chain's segments)
    through the public API on the card: loss and gradient against the
    complex128 einsum route on the card (<= 1e-5, <= 1e-4), the launches of
    one step, the medians of DM_STEPS steps on the kernel and twin routes
    in turns, and the device's busy share from a profiler window."""
    import torch
    dqt = _pkg()[0]
    label = f'noisy n={n} (rho on {2 * n} wires), {DM_LAYERS} layers'
    dqt.set_dtype('complex128')
    try:
        ref = noisy_circuit(n, 'cuda')
        if ref._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        ref_loss, ref_grad = grad_step(ref, ref.params.requires_grad_(), update=False)
        ref_loss = ref_loss.item()
        del ref
        torch.cuda.empty_cache()
    finally:
        dqt.set_dtype('complex64')
    cir = noisy_circuit(n)
    if cir.device.type != 'cuda' or not cir._planar_ok():
        raise AssertionError(f'{label}: device {cir.device}, planar {cir._planar_ok()}')
    p = cir.params.requires_grad_()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    loss, grad = grad_step(cir, p, update=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = read_counts()
    d_loss = abs(loss.item() - ref_loss)
    d_grad = (grad.double() - ref_grad).abs().max().item()
    print(f'{label}: launches per grad step {counts}, loss {loss.item():.8f} (complex128 '
          f'{ref_loss:.8f}), |d loss| {d_loss:.2e}, max|d grad| {d_grad:.2e} (max|grad| '
          f'{ref_grad.abs().max().item():.3e}), peak device memory of the step {peak:.2f} GiB')
    if not (torch.isfinite(grad).all() and d_loss <= 1e-5 and d_grad <= 1e-4):
        raise AssertionError(f'{label}: differs from the complex128 route')
    if counts['planar_apply'] < 2 * DM_LAYERS:
        raise AssertionError(f'{label}: the superoperators did not run on K1: {counts}')
    t = _in_turns(lambda: grad_step(cir, p, update=False), DM_STEPS)
    dev = _device_profile(lambda: grad_step(cir, p, update=False), 1)
    busy = dev['device_ms_per_step'] / t['kernel']
    print(f'{label}: grad step median over {DM_STEPS} (in turns: kernel, twin, twin, kernel): '
          f'kernel route {t["kernel"]:.3f} ms, twin route {t["twin"]:.3f} ms; device '
          f'{dev["device_ms_per_step"]:.3f} ms per step ({dev["device_ops_per_step"]:.0f} device '
          f'ops, busy {busy:.1%}), top '
          f'{[(k["name"][:40], round(k["ms_per_step"], 4)) for k in dev["top_kernels"][:4]]} '
          f'[{card}]')
    return counts, dict(step_ms=t['kernel'], twin_step_ms=t['twin'], device_busy_share=busy,
                        peak_gib=peak)


def check_noisy_qml(card: str, n: int = DMQ_N, batch: int = DMQ_B):
    """The batched noisy QML step: noisy_qml_circuit at n=8 on a batch of 16
    rho (16-wire planar states, per-sample planes; the depolarizing
    superoperator per sample on K1b / K5b), data from default_rng(SEED):
    loss and gradient against the complex128 einsum route, launches, the
    medians in turns with the twin route and the busy share."""
    import torch
    dqt = _pkg()[0]
    label = f'noisy QML n={n} (rho on {2 * n} wires), B={batch}'
    data = torch.as_tensor(np.random.default_rng(SEED).random((batch, n)), device='cuda')
    dqt.set_dtype('complex128')
    try:
        ref = noisy_qml_circuit('cuda', n)
        if ref._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        ref_loss, ref_grad = _noisy_qml_step(ref, ref.params.requires_grad_(), data.double())
        ref_loss = ref_loss.item()
    finally:
        dqt.set_dtype('complex64')
    cir = noisy_qml_circuit(None, n)
    if cir.device.type != 'cuda' or not cir._planar_ok():
        raise AssertionError(f'{label}: device {cir.device}, planar {cir._planar_ok()}')
    p, data = cir.params.requires_grad_(), data.float()
    reset_counts()
    loss, grad = _noisy_qml_step(cir, p, data)
    torch.cuda.synchronize()
    counts = read_counts()
    d_loss = abs(loss.item() - ref_loss)
    d_grad = (grad.double() - ref_grad).abs().max().item()
    print(f'{label}: launches per step {counts}, loss {loss.item():.8f} (complex128 '
          f'{ref_loss:.8f}), |d loss| {d_loss:.2e}, max|d grad| {d_grad:.2e}')
    if not (torch.isfinite(grad).all() and d_loss <= 1e-5 and d_grad <= 1e-4):
        raise AssertionError(f'{label}: differs from the complex128 route')
    if counts['planar_apply_batched'] < 1:
        raise AssertionError(f'{label}: the superoperator did not run on K1b: {counts}')
    t = _in_turns(lambda: _noisy_qml_step(cir, p, data), DM_STEPS)
    dev = _device_profile(lambda: _noisy_qml_step(cir, p, data), 2)
    busy = dev['device_ms_per_step'] / t['kernel']
    print(f'{label}: step median over {DM_STEPS} (in turns): kernel route {t["kernel"]:.3f} ms, '
          f'twin route {t["twin"]:.3f} ms; device {dev["device_ms_per_step"]:.3f} ms per step '
          f'(busy {busy:.1%}) [{card}]')
    return counts, dict(step_ms=t['kernel'], twin_step_ms=t['twin'], device_busy_share=busy)


def _superop_planes(kraus: np.ndarray) -> np.ndarray:
    """sum_k K (x) conj(K) of a (..., K, 2, 2) Kraus set: (..., 4, 4) on the
    wire pair (w, w + n)."""
    sop = np.einsum('...zab,...zcd->...acbd', kraus, kraus.conj())
    return sop.reshape(*sop.shape[:-4], 4, 4)


def check_superop_kernels(results: dict, rng):
    """K1 / K5 on the non-unitary maps of density matrices: the
    depolarizing superoperator (theta 0.3) on the wire pair (0, 12) of a
    24-wire planar rho, and K1b / K5b on a (16, 2, 2^16) stack with random
    non-unitary 4 x 4 per-sample planes on (0, 8) and (3, 11); states
    <= 1e-6 of max|ref| against the twin, planes <= PLANE_BAR against the
    twin run in float64; kernel, twin and device times, the bound, and the
    one torch.einsum that computes the same (library_ms, held to 1e-5 of
    the twin as for the unitary rows). Rows under ``superop`` of
    planar_apply(_batched) and planar_grad(_batched)."""
    import torch
    pg = _pkg()[1]
    dev = torch.device('cuda')
    p = np.sin(0.3) ** 2
    paulis = np.array([[[1, 0], [0, 1]], [[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]]])
    dep = np.sqrt([1 - p, p / 3, p / 3, p / 3])[:, None, None] * paulis
    cases = [(24, None, (0, 12), _superop_planes(dep))]
    for wires in ((0, 8), (3, 11)):
        cases.append((16, DMQ_B, wires, rng.standard_normal((DMQ_B, 4, 4))
                      + 1j * rng.standard_normal((DMQ_B, 4, 4))))
    for n, batch, wires, sop in cases:
        shape = (2, 1 << n) if batch is None else (batch, 2, 1 << n)
        x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
        g = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
        mre, mim = _planes(sop, dev)
        suffix = '' if batch is None else '_batched'
        label = f'n={n}' + ('' if batch is None else f', B={batch}') + f', wires={wires}'
        nbytes = 2 * x.numel() * 4
        flops = x.numel() // 2 // 4 * 8 * 16
        ref = pg.planar_evolve_xla(x, mre, mim, n, wires)
        y = pg.planar_apply(x.clone(), mre, mim, n, wires)
        torch.cuda.synchronize()
        e, d = rel_err(y, ref)
        _hold(f'planar_apply{suffix} superop {label}', e, 1e-6)
        work = x.clone()
        row = dict(shape=label, rel_err=e, max_abs_err=d,
                   ms=time_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))[0],
                   device_ms=_queued_ms(lambda: pg.planar_apply(work, mre, mim, n, wires)),
                   plain_ms=time_ms(lambda: pg.planar_evolve_xla(x, mre, mim, n, wires))[0],
                   library_ms=library_apply_ms(x, mre, mim, n, wires, ref,
                                               f'planar_apply{suffix} superop {label}'),
                   **bound(nbytes, flops))
        results[f'planar_apply{suffix}'].setdefault('superop', []).append(row)
        print(f'planar_apply{suffix} non-unitary superop {label}: {row}')
        ref, _ = planar_grad_ref(pg, g, x, n, wires)
        got = pg.planar_grad(g, x, n, wires)
        torch.cuda.synchronize()
        pe, pd = max(rel_err(a.double(), b) for a, b in zip(got, ref))
        _hold(f'planar_grad{suffix} superop {label}', pe, PLANE_BAR)
        row = dict(shape=label, plane_rel_err=pe, max_abs_err=pd,
                   ms=time_ms(lambda: pg.planar_grad(g, x, n, wires))[0],
                   device_ms=_queued_ms(lambda: pg.planar_grad(g, x, n, wires)),
                   plain_ms=time_ms(lambda: pg.planar_grad_xla(g, x, n, wires))[0],
                   library_ms=library_grad_ms(g, x, n, wires, ref,
                                              f'planar_grad{suffix} superop {label}'),
                   **bound(nbytes + 2 * mre.numel() * 4, flops))
        results[f'planar_grad{suffix}'].setdefault('superop', []).append(row)
        print(f'planar_grad{suffix} non-unitary superop {label}: {row}')


def check_hessian(card: str, n: int = 14):
    """QubitCircuit.hessian at bench_suite.py::bench_hessian's grid cell n=14,
    1 layer (_build_vqe: 42 parameters, X string on all wires): symmetric
    (<= 1e-5) and <= 1e-4 of the complex128 einsum route's Hessian; the
    time of one call and the launches it made, and the busy share of the
    gradient plus one column (a profiler window)."""
    import torch
    dqt = _pkg()[0]
    label = f'hessian n={n}, 1 layer'
    cir = bench_circuit(n, layers=1)
    if cir.device.type != 'cuda' or not cir._planar_ok():
        raise AssertionError(f'{label}: device {cir.device}, planar {cir._planar_ok()}')
    p = cir.params
    reset_counts()
    h, ms = _one_call_ms(lambda: cir.hessian(params=p))
    counts = read_counts()

    def column():
        # the gradient with create_graph and one reverse pass: a profiler
        # window over the whole call costs minutes of host time
        q = p.detach().clone().requires_grad_()
        g, = torch.autograd.grad(cir.expectation(params=q)[0], q, create_graph=True)
        torch.autograd.grad(g[0], q)

    dev = _device_profile(column, 1)
    busy = dev['device_ms_per_step'] / _one_call_ms(column)[1]
    dqt.set_dtype('complex128')
    try:
        ref_cir = bench_circuit(n, 'cuda', layers=1)
        if ref_cir._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        ref, ref_ms = _one_call_ms(lambda: ref_cir.hessian(params=p.double()))
    finally:
        dqt.set_dtype('complex64')
    d_sym = (h - h.T).abs().max().item()
    d_ref = (h.double() - ref).abs().max().item()
    print(f'{label}: {tuple(h.shape)}, launches {counts}, max|H - H^T| {d_sym:.2e}, max|d| to '
          f'complex128 {d_ref:.2e} (max|H| {ref.abs().max().item():.3e}); one call {ms:.1f} ms '
          f'(complex128 einsum route {ref_ms:.1f} ms); the gradient and one column: device '
          f'{dev["device_ms_per_step"]:.1f} ms, busy {busy:.1%} [{card}]')
    if tuple(h.shape) != (p.numel(), p.numel()) or not (d_sym <= 1e-5 and d_ref <= 1e-4):
        raise AssertionError(f'{label}: not symmetric or differs from the complex128 route')
    if counts['window_apply'] < 1:
        raise AssertionError(f'{label}: the second-order walk did not run on K2: {counts}')
    return counts, dict(ms=ms, complex128_ms=ref_ms, device_busy_share=busy)


def _one_call_ms(fn):
    """(fn(), its time in ms between two CUDA events, the host's work
    included)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _chi2(counts: dict, probs: np.ndarray, shots: int):
    """Pearson's chi-square over the outcomes with an expected count >= 5
    (the rest pooled into one cell), its degrees of freedom, and the bound
    dof + 6 sqrt(2 dof) (about six standard deviations)."""
    exp = shots * probs / probs.sum()
    obs = np.zeros(len(probs))
    for k, v in counts.items():
        obs[int(k, 2)] = v
    big = exp >= 5
    stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
    if (~big).any() and exp[~big].sum() > 0:
        stat += float((obs[~big].sum() - exp[~big].sum()) ** 2 / exp[~big].sum())
    dof = max(int(big.sum()) + int((~big).any()) - 1, 1)
    return stat, dof, dof + 6 * np.sqrt(2 * dof)


def check_measure(card: str):
    """measure() with 10^6 shots from the n=18 served state (the bench
    ansatz, 5 layers) and from the n=12 noisy rho (its diagonal), on a
    generator of the card seeded with SEED: counts sum to the shots, no
    zero-probability outcome, a chi-square against the state's
    probabilities; the time of the call."""
    import torch
    out = {}
    for label, cir in (('n=18 state', bench_circuit(18)), ('n=12 rho', noisy_circuit(12))):
        with torch.inference_mode():
            state = cir.forward()
            probs = (state.diagonal().real if cir.den_mat else state[:, 0].abs() ** 2)
            probs = probs.double().cpu().numpy()
            gen = torch.Generator(device='cuda').manual_seed(SEED)
            counts, ms = _one_call_ms(lambda: cir.measure(shots=MEASURE_SHOTS, generator=gen))
        stat, dof, bar = _chi2(counts, probs, MEASURE_SHOTS)
        zero = [k for k in counts if probs[int(k, 2)] <= 0]
        print(f'measure {label}: {MEASURE_SHOTS} shots in {ms:.1f} ms, {len(counts)} outcomes, '
              f'chi-square {stat:.1f} on {dof} dof (bound {bar:.1f}) [{card}]')
        if sum(counts.values()) != MEASURE_SHOTS or zero or not stat <= bar:
            raise AssertionError(f'measure {label}: counts {sum(counts.values())}, '
                                 f'zero-probability outcomes {zero[:3]}, chi-square {stat} > '
                                 f'{bar}')
        out[label] = dict(ms=ms, chi2=stat, dof=dof)
    return out


# ------------------------------------------------------ photonic gradients
def _rel_close(name: str, got, ref, bar: float) -> float:
    e = ((got - ref).abs().max() / ref.abs().max()).item()
    if not e <= bar:
        raise AssertionError(f'{name}: kernel and twin route gradients differ by {e} > {bar}')
    return e


def check_photonic_gradients(card: str, rng):
    """d P / d squeezing of GBS(10 modes, threshold) for a few click
    patterns through K8 (K9 with a displacement), and d P / d angles of
    Clements(12 modes, 6 photons) probabilities through K7, each against the
    twin route's autograd (relative error <= 1e-8), at complex128."""
    import torch
    dqt = _pkg()[0]
    counts = {name: 0 for name in KERNELS}
    patterns = [[1, 1, 0, 1, 0, 0, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                [0, 1, 0, 1, 0, 1, 0, 1, 0, 1]]
    with complex128():
        sq, u = rng.uniform(0.2, 0.6, GBS_MODES), _haar(GBS_MODES, rng)
        keys = [dqt.photonic.FockState(pat) for pat in patterns]
        for displaced, hot in ((False, 'tor_dets_cuda'), (True, 'tor_dets_quads_cuda')):
            cir = dqt.photonic.GaussianBosonSampling(GBS_MODES, sq, u, detector='threshold')
            if displaced:
                cir.d(0, 0.3, 0.4)
                cir.d(GBS_MODES // 2, 0.2, 1.0)
            # the squeezing magnitudes as the trainable parameters
            cir._train_mask = [False] * len(cir._pvals)
            for op in cir.operators[:GBS_MODES]:
                cir._train_mask[op.pidx[0]] = True

            def grad():
                p = cir.params.requires_grad_()
                cir(params=p)
                loss = sum(cir.get_prob(pat) for pat in patterns)
                loss.backward()
                return loss.item(), p.grad

            reset_counts()
            loss, g = grad()
            torch.cuda.synchronize()
            c = read_counts()
            with twin_route():
                ref_loss, ref = grad()
            e = _rel_close(f'GBS d P / d squeezing{", displaced" if displaced else ""}', g, ref,
                           1e-8)
            print(f'GBS {GBS_MODES} modes, threshold{", displaced" if displaced else ""}: '
                  f'd P / d squeezing of {len(patterns)} patterns (P {loss:.6e}), launches '
                  f'{ {k: v for k, v in c.items() if v} }, rel err to the twin route {e:.2e}')
            if c[hot] != len(patterns) or abs(loss - ref_loss) > 1e-8 * abs(ref_loss):
                raise AssertionError(f'GBS gradient: expected {len(patterns)} launches of {hot}')
            for name, v in c.items():
                counts[name] += v

            def grad_table():
                # the same patterns taken from the full table (one batched call
                # per click count)
                p = cir.params.requires_grad_()
                probs = cir(params=p, is_prob=True)
                loss = sum(probs[k] for k in keys)
                loss.backward()
                return loss.item(), p.grad

            reset_counts()
            loss_t, g_t = grad_table()
            torch.cuda.synchronize()
            c = read_counts()
            with twin_route():
                ref_loss_t, ref_t = grad_table()
            tag = ', displaced' if displaced else ''
            e_t = _rel_close(f'GBS d P / d squeezing from the table{tag}', g_t, ref_t, 1e-8)
            e_g = _rel_close('GBS gradient, table against get_prob', g_t, g, 1e-8)
            print(f'GBS {GBS_MODES} modes, threshold{tag}: the same gradient from the full '
                  f'table of {1 << GBS_MODES} patterns, launches '
                  f'{ {k: v for k, v in c.items() if v} }, rel err to the twin route {e_t:.2e}, '
                  f'to the get_prob route {e_g:.2e}')
            if c[f'{hot}_batched'] != GBS_MODES - 2 or c[hot] \
                    or abs(loss_t - ref_loss_t) > 1e-8 * abs(ref_loss_t):
                raise AssertionError(f'GBS table gradient: expected {GBS_MODES - 2} batched '
                                     f'launches of {hot}')
            for name, v in c.items():
                counts[name] += v

        nmode, nphoton = BS_MODES, BS_PHOTONS
        cir = dqt.photonic.Clements(nmode, init_state=[1] * nphoton + [0] * (nmode - nphoton),
                                    cutoff=nphoton + 1)
        angles = rng.uniform(0, 2 * np.pi, cir.ndata)
        keys = [dqt.photonic.FockState([1] * nphoton + [0] * (nmode - nphoton)),
                dqt.photonic.FockState([0, 1] * nphoton),
                dqt.photonic.FockState([2, 0, 0, 1, 1, 0, 0, 1, 0, 1, 0, 0])]

        def grad():
            d = torch.tensor(angles, device='cuda', requires_grad=True)
            probs = cir(data=d, is_prob=True)
            sum(probs[k] for k in keys).backward()
            return d.grad

        reset_counts()
        g = grad()
        torch.cuda.synchronize()
        c = read_counts()
        with twin_route():
            ref = grad()
        e = _rel_close('Clements d P / d angles', g, ref, 1e-8)
        print(f'boson sampling {nmode} modes, {nphoton} photons: d P / d angles ({cir.ndata} '
              f'angles, {len(keys)} outcomes), launches {c["permanent_cuda_batch"]} of '
              f'permanent_cuda_batch, rel err to the twin route {e:.2e} [{card}]')
        if c['permanent_cuda_batch'] != 1:
            raise AssertionError('Clements gradient: expected one permanent launch')
        for name, v in c.items():
            counts[name] += v
    return counts


# ---------------------------------------------------------------- photonic
def _ryser_numpy(a: np.ndarray, dtype=np.complex128) -> complex:
    """Ryser permanent of one matrix in numpy, by doubling: the column sums
    of the subsets of the first i + 1 rows are those of the first i rows,
    and those plus row i. With ``np.clongdouble`` (64-bit mantissa on x86)
    it is the yardstick for the float64 sweeps at n = 20."""
    n = a.shape[0]
    a = a.astype(dtype)
    sums = np.zeros((1, n), dtype)
    signs = np.ones(1, dtype)
    for i in range(n):
        sums = np.concatenate([sums, sums + a[i]])
        signs = np.concatenate([signs, -signs])
    return complex((-1) ** n * np.sum(signs * np.prod(sums, axis=1)))


def _perm_bar(n: int) -> float:
    """Kernel against twin, both float64 sweeps in different orders. A term
    (a product of n column sums) carries about n * 2^-53 of its own size, and
    the 2^n terms cancel down to a permanent some 1e4 (n = 20) to 1e5
    (n = 22) times smaller than their typical size: the card reads 1e-12 at
    n = 14, 6e-11 at n = 20 and 4e-10 at n = 22."""
    return 1e-10 if n <= 14 else 1e-8


BS_MODES, BS_PHOTONS = 12, 6      # path (a): C(17, 6) = 12376 outcomes
BS_BIG = 20                       # get_amplitude: one 20 x 20 permanent
GBS_MODES, GBS_BIG = 10, 14       # path (b): 1024 patterns; the kernel's limit 2m = 28
TOR_MODES = (14, 8, 10, 12)       # m = 14 first: the shape get_prob gives at 14 modes
# the batched K8 / K9 at path (b)'s own stacks: (modes of the GBS state, clicks k),
# B = C(modes, k) matrices of 2k x 2k; the 14-mode row first (the heaviest)
TOR_STACKS = [(14, 10), (10, 3), (10, 5), (10, 8), (10, 10)]
PERM_SHAPES = [   # (B, n, input type); the first two are what path (a) gives the kernel
    (12376, 6, 'complex128'), (1, 20, 'complex128'), (3, 4, 'complex128'), (2, 5, 'complex64'),
    (1000, 14, 'complex64'), (4, 20, 'complex64'), (1, 22, 'complex128'),
    (1, 26, 'complex128')]        # n = 26: too slow for the twin, time and a finite value only


def check_permanent_kernel(results: dict, rng):
    """Phase 3, K7 on Haar unitaries, against its twin and a numpy Ryser."""
    import torch
    pk = _photonic()[0]
    dev = torch.device('cuda')
    rows = []
    for b, n, dtype in PERM_SHAPES:
        mats = torch.as_tensor(np.stack([_haar(n, rng) for _ in range(b)]), device=dev).to(
            getattr(torch, dtype))
        got = pk.permanent_cuda_batch(mats)
        torch.cuda.synchronize()
        if got.dtype != torch.complex128 or tuple(got.shape) != (b,):
            raise AssertionError(f'permanent (B={b}, n={n}): {got.dtype} {tuple(got.shape)}')
        if not torch.equal(got, pk.permanent_cuda_batch(mats)):
            raise AssertionError(f'permanent (B={b}, n={n}): differs between two launches')
        tk_ms, _ = time_ms(lambda: pk.permanent_cuda_batch(mats), reps=10 if n >= 22 else REPS)
        td_ms = _queued_ms(lambda: pk.permanent_cuda_batch(mats), reps=10 if n >= 22 else REPS)
        if (b, n) in ((12376, 6), (1, 20)):   # path (a)'s and get_amplitude's shapes
            check_one_launch(lambda: pk.permanent_cuda_batch(mats), 5,
                             f'permanent_cuda_batch B={b} n={n}', 'ryser_kernel')
        # n complex adds and n complex multiplies per subset (Gray-code Ryser)
        bnd = bound(mats.numel() * mats.element_size() + b * 16, b * (1 << n) * 8 * n, PEAK_FP64_S)
        if n > 22:
            if not torch.isfinite(torch.view_as_real(got)).all():
                raise AssertionError(f'permanent n={n}: non-finite')
            print(f'permanent_cuda_batch B={b} n={n} {dtype}: value {complex(got[0]):.6e}, '
                  f'kernel {tk_ms:.4f} ms, device {td_ms:.4f} ms '
                  f'({bnd["bound_ms"] / td_ms:.0%} of the bound), bound {bnd["bound_ms"]:.4f} ms '
                  f'({bnd["bound_by"]})')
            rows.append(dict(shape=f'B={b}, n={n}, {dtype}', ms=tk_ms, device_ms=td_ms, **bnd))
            continue
        ref = pk.permanent_plain_batch(mats)
        e, d = rel_err(got, ref)
        _hold(f'permanent_cuda_batch B={b} n={n}', e, _perm_bar(n))
        e_np = None
        if n <= 14 or (b, n) == (1, 20):
            host = mats[:8].cpu().numpy().astype(np.complex128)
            oracle = np.array([_ryser_numpy(m, np.complex128 if n <= 14 else np.clongdouble)
                               for m in host])
            e_np = float(np.abs(got[:8].cpu().numpy() - oracle).max() / np.abs(oracle).max())
            _hold(f'permanent_cuda_batch B={b} n={n} against numpy', e_np, _perm_bar(n))
            if n == 20:
                e_twin = float(np.abs(ref.cpu().numpy() - oracle).max() / np.abs(oracle).max())
                print(f'permanent n=20 against a long-double numpy Ryser: kernel {e_np:.2e}, '
                      f'twin {e_twin:.2e}')
        tp_ms, _ = time_ms(lambda: pk.permanent_plain_batch(mats), reps=5, warmup=1)
        print(f'permanent_cuda_batch B={b} n={n} {dtype}: rel err {e:.2e}'
              + (f' (numpy Ryser {e_np:.2e})' if e_np is not None else '')
              + f', kernel {tk_ms:.4f} ms, device {td_ms:.4f} ms '
              f'({bnd["bound_ms"] / td_ms:.0%} of the bound), twin {tp_ms:.4f} ms, bound '
              f'{bnd["bound_ms"]:.5f} ms ({bnd["bound_by"]})')
        rows.append(dict(shape=f'B={b}, n={n}, {dtype}', ms=tk_ms, device_ms=td_ms, plain_ms=tp_ms,
                         rel_err=e, max_abs_err=d, **bnd))
    # no single PyTorch call computes a permanent: library_ms stays null
    results['permanent_cuda_batch'] = dict(rows[0], plane_rel_err=None, other_shapes=rows[1:])


def _tor_inputs(m: int, rng, perturb: bool):
    """O = I - (I + M M^T)^-1 (symmetric), optionally plus a small
    non-symmetric complex perturbation, and gamma with gamma[m:] =
    conj(gamma[:m])."""
    mm = rng.standard_normal((2 * m, 2 * m)) * 0.1
    o = (np.eye(2 * m) - np.linalg.inv(np.eye(2 * m) + mm @ mm.T)).astype(np.complex128)
    if perturb:
        o = o + 0.01 * (rng.standard_normal((2 * m, 2 * m))
                        + 1j * rng.standard_normal((2 * m, 2 * m)))
    gam = rng.standard_normal(2 * m) * 0.1 + 0.05j * rng.standard_normal(2 * m)
    gam[m:] = np.conj(gam[:m])
    return o, gam


def check_tor_kernels(results: dict, rng):
    """Phase 3, K8 and K9 against their twins; K8 also against the library's
    batched determinant on stacks gathered beforehand."""
    import torch
    from math import comb
    _, _, tk, pt = _photonic()
    dev = torch.device('cuda')
    rows8, rows9 = [], []
    for m in TOR_MODES:
        idx, valid, sign = pt._padded_tor_indices(m, dev)
        nsub = idx.shape[0]
        lu_flops = sum(comb(m, r) * 8 * (2 * r) ** 3 / 3 for r in range(1, m + 1))
        solve_flops = sum(comb(m, r) * 8 * (2 * r) ** 2 for r in range(1, m + 1))
        scaffold_bytes = idx.numel() * 8 + valid.numel() * 4
        for perturb in (False, True):
            o_np, g_np = _tor_inputs(m, rng, perturb)
            o, g = torch.as_tensor(o_np, device=dev), torch.as_tensor(g_np, device=dev)
            label = f'm={m}, {"non-symmetric" if perturb else "symmetric"} O'
            det, _ = tk.tor_dets_cuda(o, idx, valid, sign)
            det9, quad, _ = tk.tor_dets_quads_cuda(o, g, idx, valid, sign)
            torch.cuda.synchronize()
            ref, _ = tk.tor_dets_plain(o, idx, valid, sign)
            ref9, refq, _ = tk.tor_dets_quads_plain(o, g, idx, valid, sign)
            e8 = ((det - ref).abs() / ref.abs()).max().item()
            e9 = max(((det9 - ref9).abs() / ref9.abs()).max().item(),
                     ((quad - refq).abs() / refq.abs()).max().item())
            _hold(f'tor_dets_cuda {label}', e8, 1e-9)
            _hold(f'tor_dets_quads_cuda {label}', e9, 1e-9)
            t8, t8r = pt._tor_epilogue(det, sign, m), pt._tor_epilogue(ref, sign, m)
            t9, t9r = pt._tor_epilogue(det9, sign, m, quad), pt._tor_epilogue(ref9, sign, m, refq)
            et8 = (abs(t8 - t8r) / abs(t8r)).item()
            et9 = (abs(t9 - t9r) / abs(t9r)).item()
            # the signed sum cancels: two float64 sums of terms that agree to
            # 1e-15 can differ by that times the cancellation (sum |term| over
            # |torontonian|: 1e8 at m = 8, 1e11 at m = 14), so the bar is 1e-6
            # where the cancellation allows it and 1e-15 times it beyond
            amp8 = ((1 / ref.sqrt()).abs().sum() / abs(t8r)).item()
            amp9 = ((refq / 2).exp() / ref9.sqrt()).abs().sum().item() / abs(t9r).item()
            _hold(f'torontonian from tor_dets_cuda {label}', et8, max(1e-6, 1e-15 * amp8))
            _hold(f'torontonian from tor_dets_quads_cuda {label}', et9, max(1e-6, 1e-15 * amp9))
            k8, _ = time_ms(lambda: tk.tor_dets_cuda(o, idx, valid, sign))
            k9, _ = time_ms(lambda: tk.tor_dets_quads_cuda(o, g, idx, valid, sign))
            d8 = _queued_ms(lambda: tk.tor_dets_cuda(o, idx, valid, sign))
            d9 = _queued_ms(lambda: tk.tor_dets_quads_cuda(o, g, idx, valid, sign))
            p8, _ = time_ms(lambda: tk.tor_dets_plain(o, idx, valid, sign), reps=5, warmup=1)
            p9, _ = time_ms(lambda: tk.tor_dets_quads_plain(o, g, idx, valid, sign), reps=5,
                            warmup=1)
            # the library yardstick, used nowhere in the port: one batched det per
            # size group on stacks gathered outside the timed region
            stacks = [tk._gathered(o, idx, p, a, b)[0] for p, a, b in tk._group_slices(m)]
            lib, _ = time_ms(lambda: [torch.linalg.det(st) for st in stacks], reps=5, warmup=1)
            b8 = bound(o.numel() * 16 + scaffold_bytes + nsub * 16, lu_flops, PEAK_FP64_S)
            b9 = bound((o.numel() + g.numel()) * 16 + scaffold_bytes + nsub * 32,
                       lu_flops + solve_flops, PEAK_FP64_S)
            print(f'tor_dets_cuda {label} ({nsub} subsets): det rel err {e8:.2e}, torontonian '
                  f'{t8.real.item():.6e} rel err {et8:.2e} (terms cancel by {amp8:.1e}), '
                  f'kernel {k8:.4f} ms (device {d8:.4f} ms), twin {p8:.4f} ms, '
                  f'linalg.det on gathered stacks {lib:.4f} ms, bound {b8["bound_ms"]:.5f} ms '
                  f'({b8["bound_by"]})')
            print(f'tor_dets_quads_cuda {label}: det / quad rel err {e9:.2e}, torontonian '
                  f'{t9.real.item():.6e} rel err {et9:.2e}, kernel {k9:.4f} ms (device '
                  f'{d9:.4f} ms), twin {p9:.4f} ms, bound {b9["bound_ms"]:.5f} ms '
                  f'({b9["bound_by"]})')
            rows8.append(dict(shape=label, ms=k8, device_ms=d8, plain_ms=p8, library_ms=lib,
                              rel_err=e8, max_abs_err=(det - ref).abs().max().item(),
                              torontonian_rel_err=et8, **b8))
            rows9.append(dict(shape=label, ms=k9, device_ms=d9, plain_ms=p9, rel_err=e9,
                              max_abs_err=max((det9 - ref9).abs().max().item(),
                                              (quad - refq).abs().max().item()),
                              torontonian_rel_err=et9, **b9))
    # K9 has no single library call: det and solve are two, and the form a third
    results['tor_dets_cuda'] = dict(rows8[0], plane_rel_err=None, other_shapes=rows8[1:])
    results['tor_dets_quads_cuda'] = dict(rows9[0], plane_rel_err=None, other_shapes=rows9[1:])


def _gbs_circuit(nmode: int, displaced: bool, rng):
    """GaussianBosonSampling(nmode, threshold) with seeded squeezing in
    [0.2, 0.6] and a Haar mesh; displaced on two modes on request."""
    dqt = _pkg()[0]
    cir = dqt.photonic.GaussianBosonSampling(
        nmode, rng.uniform(0.2, 0.6, nmode), _haar(nmode, rng), detector='threshold')
    if displaced:
        cir.d(0, 0.3, 0.4)
        cir.d(nmode // 2, 0.2, 1.0)
    return cir


def _click_stacks(nmode: int, rng) -> list:
    """Path (b)'s own stacks at nmode modes, as the threshold table gathers
    them: per click count k the (C(nmode, k), 2k, 2k) O sub-matrices of an
    undisplaced state (K8's) and of a displaced one with their gammas
    (K9's)."""
    import itertools
    from deepquantum_tpu_torch.photonic import gaussian_prob as gp
    basis = list(itertools.product((0, 1), repeat=nmode))
    out = []
    for displaced in (False, True):
        cov, mean = _gbs_circuit(nmode, displaced, rng)()
        _, o_mat, gamma, _ = gp._q_mats(cov[0], mean[0])
        out.append({k: gp.gather_group(o_mat, gamma if displaced else None, idx)
                    for k, (_, idx) in gp.click_groups(basis, nmode).items()})
    return out


def _tor_bar(tor, tor_ref, terms):
    """Per torontonian: the relative error and its bar, 1e-6 or 1e-15 times
    the cancellation (sum |term| / |torontonian|) where that is more."""
    err = (tor - tor_ref).abs() / tor_ref.abs()
    amp = terms.abs().sum(-1) / tor_ref.abs()
    return err, (1e-15 * amp).clamp(min=1e-6)


def check_tor_batched(results: dict, rng):
    """Phase 3, the batched K8 and K9 (one wrapper call on a (B, 2m, 2m)
    stack) at path (b)'s own stacks against their batched twins: per subset
    <= 1e-9, per torontonian the bar of check_tor_kernels; times through
    the wrapper, device time (``_queued_ms``), the FP64 bound, and for
    K8 torch.linalg.det on the pre-gathered stacks."""
    import torch
    from math import comb
    _, _, tk, pt = _photonic()
    stacks = {n: _click_stacks(n, rng) for n in sorted({n for n, _ in TOR_STACKS})}
    rows8, rows9 = [], []
    for nmode, k in TOR_STACKS:
        (o8, _), (o9, g9) = stacks[nmode][0][k], stacks[nmode][1][k]
        b = o8.shape[0]
        idx, valid, sign = pt._padded_tor_indices(k, o8.device)
        nsub = idx.shape[0]
        label = f'(B, m) = ({b}, {k}), the {k}-click stack of {nmode} modes'
        lu_flops = b * sum(comb(k, r) * 8 * (2 * r) ** 3 / 3 for r in range(1, k + 1))
        solve_flops = b * sum(comb(k, r) * 8 * (2 * r) ** 2 for r in range(1, k + 1))
        det, _ = tk.tor_dets_cuda(o8, idx, valid, sign)
        det9, quad, _ = tk.tor_dets_quads_cuda(o9, g9, idx, valid, sign)
        torch.cuda.synchronize()
        ref, _ = tk.tor_dets_plain(o8, idx, valid, sign)
        ref9, refq, _ = tk.tor_dets_quads_plain(o9, g9, idx, valid, sign)
        e8 = ((det - ref).abs() / ref.abs()).max().item()
        e9 = max(((det9 - ref9).abs() / ref9.abs()).max().item(),
                 ((quad - refq).abs() / refq.abs()).max().item())
        _hold(f'tor_dets_cuda batched {label}', e8, 1e-9)
        _hold(f'tor_dets_quads_cuda batched {label}', e9, 1e-9)
        et8, bar8 = _tor_bar(pt._tor_epilogue(det, sign, k), pt._tor_epilogue(ref, sign, k),
                             sign / ref.sqrt())
        et9, bar9 = _tor_bar(pt._tor_epilogue(det9, sign, k, quad),
                             pt._tor_epilogue(ref9, sign, k, refq),
                             sign * (refq / 2).exp() / ref9.sqrt())
        for name, et, bar in (('tor_dets_cuda', et8, bar8), ('tor_dets_quads_cuda', et9, bar9)):
            if not bool((et <= bar).all()):
                i = int((et / bar).argmax())
                raise AssertionError(f'torontonians from {name} batched {label}: matrix {i} '
                                     f'rel err {et[i].item()} > {bar[i].item()}')
        k8, _ = time_ms(lambda: tk.tor_dets_cuda(o8, idx, valid, sign))
        k9, _ = time_ms(lambda: tk.tor_dets_quads_cuda(o9, g9, idx, valid, sign))
        d8 = _queued_ms(lambda: tk.tor_dets_cuda(o8, idx, valid, sign))
        d9 = _queued_ms(lambda: tk.tor_dets_quads_cuda(o9, g9, idx, valid, sign))
        p8, _ = time_ms(lambda: tk.tor_dets_plain(o8, idx, valid, sign), reps=5, warmup=1)
        p9, _ = time_ms(lambda: tk.tor_dets_quads_plain(o9, g9, idx, valid, sign), reps=5,
                        warmup=1)
        # the library yardstick, used nowhere in the port: one batched det per
        # size group on the stack's subsets gathered outside the timed region
        gathered = [tk._gathered(o8, idx, p, a, c)[0] for p, a, c in tk._group_slices(k)]
        lib, _ = time_ms(lambda: [torch.linalg.det(st) for st in gathered], reps=5, warmup=1)
        b8 = bound(o8.numel() * 16 + idx.numel() * 8 + b * nsub * 16, lu_flops, PEAK_FP64_S)
        b9 = bound((o9.numel() + g9.numel()) * 16 + idx.numel() * 8 + b * nsub * 32,
                   lu_flops + solve_flops, PEAK_FP64_S)
        for name, t, dev, e, et, bnd in (('tor_dets_cuda', k8, d8, e8, et8, b8),
                                         ('tor_dets_quads_cuda', k9, d9, e9, et9, b9)):
            print(f'{name} batched {label} ({b * nsub} subsets): per-subset rel err {e:.2e}, '
                  f'torontonians rel err <= {et.max().item():.2e}, kernel {t:.4f} ms, device '
                  f'{dev:.4f} ms, bound {bnd["bound_ms"]:.5f} ms ({bnd["bound_by"]}, '
                  f'{bnd["bound_ms"] / dev:.0%} of the device time)')
        print(f'  twins {p8:.4f} / {p9:.4f} ms, linalg.det on the gathered stacks {lib:.4f} ms')
        rows8.append(dict(shape=label, ms=k8, device_ms=d8, plain_ms=p8, library_ms=lib,
                          rel_err=e8, max_abs_err=(det - ref).abs().max().item(),
                          torontonian_rel_err=et8.max().item(), **b8))
        rows9.append(dict(shape=label, ms=k9, device_ms=d9, plain_ms=p9, rel_err=e9,
                          max_abs_err=max((det9 - ref9).abs().max().item(),
                                          (quad - refq).abs().max().item()),
                          torontonian_rel_err=et9.max().item(), **b9))
    results['tor_dets_cuda_batched'] = dict(rows8[0], plane_rel_err=None, other_shapes=rows8[1:])
    results['tor_dets_quads_cuda_batched'] = dict(rows9[0], plane_rel_err=None,
                                                  other_shapes=rows9[1:])


def _by_state(out: dict) -> dict:
    return {tuple(k.state.tolist()): v for k, v in out.items()}


def _probs_close(name: str, got: dict, ref: dict, bar: float):
    got, ref = _by_state(got), _by_state(ref)
    if got.keys() != ref.keys():
        raise AssertionError(f'{name}: the routes give different outcomes')
    import torch
    keys = list(ref)
    d = (torch.stack([got[k] for k in keys]) - torch.stack([ref[k] for k in keys])).abs().max()
    if not d.item() <= bar:
        raise AssertionError(f'{name}: kernel and twin route differ by {d.item()} > {bar}')
    return d.item()


def check_boson_sampling(card: str, rng):
    """Phase 8, path (a): the Fock backend in basis mode, at complex128."""
    import torch
    from math import comb
    dqt = _pkg()[0]
    with complex128():
        nmode, nphoton = BS_MODES, BS_PHOTONS
        cir = dqt.photonic.Clements(nmode, init_state=[1] * nphoton + [0] * (nmode - nphoton),
                                    cutoff=nphoton + 1)
        if cir.device.type != 'cuda':
            raise AssertionError(f'boson sampling: the circuit landed on {cir.device}')
        angles = rng.uniform(0, 2 * np.pi, cir.ndata)
        with torch.no_grad():
            reset_counts()
            probs = cir(data=angles, is_prob=True)
            torch.cuda.synchronize()
            counts = read_counts()
            total = torch.stack(list(probs.values())).sum().item()
            print(f'boson sampling {nmode} modes, {nphoton} photons: {len(probs)} outcomes, '
                  f'sum {total:.10f}, launches {counts}')
            nout = comb(nmode + nphoton - 1, nphoton)
            if len(probs) != nout or counts['permanent_cuda_batch'] != 1:
                raise AssertionError(f'boson sampling: expected {nout} outcomes from one launch')
            if not abs(total - 1) <= 1e-6:
                raise AssertionError(f'boson sampling: probabilities sum to {total}')
            t_kernel, _ = time_ms(lambda: cir(data=angles, is_prob=True), reps=5, warmup=1)
            reset_counts()
            with twin_route():
                ref = cir(data=angles, is_prob=True)
                t_twin, _ = time_ms(lambda: cir(data=angles, is_prob=True), reps=5, warmup=1)
            if sum(read_counts().values()) != 0:
                raise AssertionError('the twin route launched a kernel')
            d = _probs_close('boson sampling', probs, ref, 1e-8)
            print(f'boson sampling: max |d prob| to the twin route {d:.2e}; median over 5 calls: '
                  f'kernel route {t_kernel:.3f} ms, twin route {t_twin:.3f} ms [{card}]')

            n20 = BS_BIG
            big = dqt.photonic.Clements(n20, init_state=[1] * n20, cutoff=n20 + 1)
            big.encode(rng.uniform(0, 2 * np.pi, big.ndata))
            reset_counts()
            amp = big.get_amplitude([1] * n20)
            torch.cuda.synchronize()
            c20 = read_counts()
            with twin_route():
                amp_ref = big.get_amplitude([1] * n20)
            e = (abs(amp - amp_ref) / abs(amp_ref)).item()
            t_amp, _ = time_ms(lambda: big.get_amplitude([1] * n20), reps=5, warmup=1)
            print(f'get_amplitude {n20} modes, {n20} photons: {complex(amp):.6e}, rel err to the '
                  f'twin route {e:.2e}, launches {c20}, median {t_amp:.3f} ms [{card}]')
            if c20['permanent_cuda_batch'] != 1 or not e <= 1e-8:
                raise AssertionError('get_amplitude: expected one launch and the twin value')
    for name, c in c20.items():
        counts[name] += c
    return counts


def _pattern_bars(cir, nmode: int, displaced: bool) -> dict:
    """Each click pattern's bar against the twin route: its torontonian's
    (1e-6, or 1e-15 times the cancellation of its terms where that is more;
    the plain formula below 3 clicks is the same code on both routes)."""
    import itertools
    import torch
    from deepquantum_tpu_torch.photonic import gaussian_prob as gp
    _, _, tk, pt = _photonic()
    basis = list(itertools.product((0, 1), repeat=nmode))
    cov, mean = cir()
    _, o_mat, gamma, _ = gp._q_mats(cov[0], mean[0])
    bars = {b: 1e-6 for b in basis}
    for k, (pos, idx) in gp.click_groups(basis, nmode).items():
        if k < 3:
            continue
        sub, g = gp.gather_group(o_mat, gamma if displaced else None, idx)
        scaffold = pt._padded_tor_indices(k, sub.device)
        if displaced:
            det, quad, sign = tk.tor_dets_quads_plain(sub, g, *scaffold)
            terms = sign * (quad / 2).exp() / det.sqrt()
        else:
            det, sign = tk.tor_dets_plain(sub, *scaffold)
            terms = sign / det.sqrt()
        amp = terms.abs().sum(-1) / (terms.sum(-1) + (-1) ** k).abs()
        for i, bar in zip(pos, (1e-15 * amp).clamp(min=1e-6).tolist()):
            bars[basis[i]] = bar
    return bars


def check_gbs(card: str, rng):
    """Phase 9, path (b): Gaussian boson sampling with click detectors, at
    complex128. Every pattern's probability at 10 and 14 modes, one batched
    K8 (K9 when displaced) wrapper call per click count >= 3; get_prob of
    all clicks at 14 modes, one single call."""
    import torch
    total_counts = {name: 0 for name in KERNELS}

    def add(counts):
        for name, c in counts.items():
            total_counts[name] += c

    with complex128(), torch.no_grad():
        for displaced, hot, cold in ((False, 'tor_dets_cuda', 'tor_dets_quads_cuda'),
                                     (True, 'tor_dets_quads_cuda', 'tor_dets_cuda')):
            for nmode in (GBS_MODES, GBS_BIG):
                cir = _gbs_circuit(nmode, displaced, rng)
                label = f'GBS {nmode} modes, threshold' + (', displaced' if displaced else '')
                reset_counts()
                probs = cir(is_prob=True)
                torch.cuda.synchronize()
                counts = read_counts()
                total = torch.stack(list(probs.values())).sum().item()
                print(f'{label}: {len(probs)} patterns, sum {total:.10f}, launches '
                      f'{ {k: v for k, v in counts.items() if v} }')
                # one batched call per click count k = 3 .. nmode, nothing else
                if len(probs) != 1 << nmode or counts[f'{hot}_batched'] != nmode - 2 \
                        or counts[hot] or counts[cold] or counts[f'{cold}_batched']:
                    raise AssertionError(f'{label}: expected {nmode - 2} batched launches of '
                                         f'{hot} and no other')
                if not abs(total - 1) <= 1e-6:
                    raise AssertionError(f'{label}: probabilities sum to {total}')
                t_kernel, _ = time_ms(lambda: cir(is_prob=True), reps=3, warmup=1)
                reset_counts()
                with twin_route():
                    ref = cir(is_prob=True)
                    t_twin, _ = time_ms(lambda: cir(is_prob=True), reps=3, warmup=0)
                if sum(read_counts().values()) != 0:
                    raise AssertionError('the twin route launched a kernel')
                if nmode == GBS_MODES:
                    d = _probs_close(label, probs, ref, 1e-8)
                    held = f'max |d prob| to the twin route {d:.2e}'
                else:
                    # 16384 torontonians whose terms cancel by up to 1e11: each
                    # pattern is held to its own torontonian's bar
                    bars = _pattern_bars(cir, nmode, displaced)
                    got, want = _by_state(probs), _by_state(ref)
                    worst = max((abs(got[k] - want[k]) / want[k]).item() / bars[k] for k in want)
                    if not worst <= 1:
                        raise AssertionError(f'{label}: a pattern misses its bar by x{worst}')
                    held = (f'every pattern within its bar (1e-6 or 1e-15 x cancellation) of the '
                            f'twin route, at most {worst:.2e} of it')
                print(f'{label}: {held}; median over 3 calls: kernel route {t_kernel:.3f} ms, '
                      f'twin route {t_twin:.3f} ms [{card}]')
                add(counts)

            big = _gbs_circuit(GBS_BIG, displaced, rng)
            big()                                   # the Gaussian state of the circuit
            clicks = [1] * GBS_BIG
            reset_counts()
            p = big.get_prob(clicks)
            torch.cuda.synchronize()
            counts = read_counts()
            with twin_route():
                p_ref = big.get_prob(clicks)
            e = (abs(p - p_ref) / abs(p_ref)).item()
            t_p, _ = time_ms(lambda: big.get_prob(clicks), reps=5, warmup=1)
            print(f'get_prob all-click at {GBS_BIG} modes{", displaced" if displaced else ""}: '
                  f'{p.item():.6e}, rel err to the twin route {e:.2e}, launches '
                  f'{ {k: v for k, v in counts.items() if v} }, median {t_p:.3f} ms [{card}]')
            # 1e-3: the 16383 terms of this torontonian cancel by 1e11 to 1e12, so
            # two float64 routes agree to 1e-5 to 1e-4 of the probability at best
            # (phase 3 holds the per-subset values themselves at 1e-9)
            if counts[hot] != 1 or sum(counts.values()) != 1 or not e <= 1e-3 \
                    or not 0 < p.item() < 1:
                raise AssertionError('get_prob of all clicks: expected one single launch of '
                                     f'{hot} and the twin value')
            add(counts)
    return total_counts


# ------------------------------------------- the continuous-variable engine
CV_SHOTS = 100_000
GRAPH_NODES, GRAPH_SMALL, GRAPH_CLIQUE = 14, 10, 6
LOSS_DB = 3.0
HOMODYNE_WIRES = (1, 4, 7, 12)
BOREALIS_LOOPS, BOREALIS_BATCH, BOREALIS_STEPS = (1, 6, 36), 64, 216
CLUSTER_DELAYS, CLUSTER_STEPS = (1, 12), 200
TDM_BUSY_STEPS = 20
BOSONIC_SHOTS, MARGINAL_SHOTS, WIGNER_POINTS = 1000, 20_000, 100
# float32 against float64 on the same inputs (the card read 6.6e-7 / 8.5e-7
# for the 14-mode homodyne's covariance / mean, 6.0e-7 for the Borealis
# covariance over 216 steps, 1.8e-7 for the 10-mode pnrd table)
HOMODYNE_COV_BAR = HOMODYNE_MEAN_BAR = 1e-6
TDM_COV_BAR = 1e-5
# every step's samples and the last means, complex64 against complex128,
# over the run's largest |mean| or |sample| (the card read 8.8e-5 for the
# Borealis means after 216 steps of feedback)
TDM_FEEDBACK_BAR = 1e-3
PNRD_BAR = 1e-6


def _cv_stats(fn):
    """(fn(), stats): one call's time between CUDA events, the K8b / K9b
    wrapper calls it made and its peak device memory; a second call's time
    (``again_ms``: the first launch of a library kernel in the process can
    take seconds of host time, as tools/pnrd_first_call.py traces), and
    the device's busy share: a third call's device time (a profiler window
    with CUDA activity only) over the second call's time."""
    import torch
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out, ms = _one_call_ms(fn)
    counts = {k: v for k, v in read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, again = _one_call_ms(fn)
    device_ms = _cuda_only_device_ms(fn)
    return out, dict(ms=ms, again_ms=again, launches=counts, peak_gib=round(peak, 3),
                     busy=round(device_ms / again, 4))


def _stats_text(s: dict) -> str:
    launches = ', '.join(f'{k} {v}' for k, v in s['launches'].items()) or 'none'
    return (f"{s['ms']:.1f} ms (again {s['again_ms']:.1f}), launches {launches}, peak "
            f"{s['peak_gib']} GiB, busy {100 * s['busy']:.1f} %")


def _dict_chi2(counts: dict, table: dict, shots: int):
    """Pearson's chi-square of sampled counts {FockState: n} against a
    probability table {FockState: p} (normalised), the cells with an
    expected count >= 5 and the rest pooled; its dof and the bound
    dof + 6 sqrt(2 dof)."""
    keys = list(table)
    p = np.array([float(table[k]) for k in keys])
    exp = shots * p / p.sum()
    obs = np.array([counts.get(k, 0) for k in keys], dtype=np.float64)
    if sum(counts.values()) != shots or not set(counts) <= set(keys):
        raise AssertionError('samples: wrong total or an outcome outside the table')
    big = exp >= 5
    stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
    if (~big).any() and exp[~big].sum() > 0:
        stat += float((obs[~big].sum() - exp[~big].sum()) ** 2 / exp[~big].sum())
    dof = max(int(big.sum()) + int((~big).any()) - 1, 1)
    return stat, dof, dof + 6 * np.sqrt(2 * dof)


def _hold_chi2(label: str, stat: float, dof: int, bar: float):
    if not stat <= bar:
        raise AssertionError(f'{label}: chi-square {stat} on {dof} dof above {bar}')


def _planted_graph(n: int, clique: int, rng):
    """A G(n, 1/2) adjacency matrix with a clique planted on ``clique`` of
    its first GRAPH_SMALL nodes (so the 10-node subgraph holds it too)."""
    a = np.triu((rng.random((n, n)) < 0.5).astype(float), 1)
    nodes = np.sort(rng.choice(min(n, GRAPH_SMALL), clique, replace=False))
    a[np.ix_(nodes, nodes)] = 1
    a = np.triu(a, 1)
    return a + a.T, nodes.tolist()


def check_graph_gbs(card: str, rng):
    """Phase 9h, graph GBS for dense subgraphs (Arrazola & Bromley, PRL 121,
    030503): GraphGBS on G(14, 1/2) with a planted 6-clique, 14 photons on
    average, threshold detectors, at complex128: all 16 384 click patterns
    in 12 batched K8 calls (sum 1 within 1e-6), measure(10^5 shots) by a
    chi-square against the table, postselect on 6 and 8 clicks. Then the
    10-node subgraph with pnrd detectors, cutoff 2: all 1024 outcomes in one
    hafnian_batch call per photon number, complex64 against complex128
    (hafnian_batch computes in complex128 at either precision, so PNRD_BAR
    holds the Q-matrix stage)."""
    import importlib
    import torch
    dqt = _pkg()[0]
    from deepquantum_tpu_torch.photonic import gaussian_prob as gp
    adj, clique = _planted_graph(GRAPH_NODES, GRAPH_CLIQUE, rng)
    out, counts_all = {}, {}
    with complex128(), torch.no_grad():
        gbs = dqt.photonic.GraphGBS(adj, mean_photon_num=GRAPH_NODES, detector='threshold',
                                    rng=np.random.default_rng(SEED))
        table, stats = _cv_stats(lambda: gbs(is_prob=True))
        counts_all = dict(stats['launches'])
        total = torch.stack(list(table.values())).sum().item()
        print(f'GraphGBS {GRAPH_NODES} nodes, threshold: c {gbs.c:.6f}, {len(table)} patterns, '
              f'sum {total:.10f}; {_stats_text(stats)} [{card}]')
        if stats['launches'] != {'tor_dets_cuda_batched': GRAPH_NODES - 2} \
                or len(table) != 1 << GRAPH_NODES or not abs(total - 1) <= 1e-6:
            raise AssertionError(f'GraphGBS table: launches {stats["launches"]}, sum {total}')
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        samples, ms = _one_call_ms(lambda: gbs.measure(shots=CV_SHOTS, generator=gen))
        stat, dof, bar = _dict_chi2(samples, table, CV_SHOTS)
        six, eight = gbs.postselect(samples, [6, 8])
        hit = samples.get(dqt.FockState([int(i in clique) for i in range(GRAPH_NODES)]), 0)
        p_clique = float(table[dqt.FockState([int(i in clique) for i in range(GRAPH_NODES)])])
        print(f'GraphGBS measure({CV_SHOTS}): {ms:.1f} ms, {len(samples)} patterns, chi-square '
              f'{stat:.1f} on {dof} dof (bound {bar:.1f}); postselect 6 clicks {sum(six.values())} '
              f'samples ({len(six)} patterns), 8 clicks {sum(eight.values())} ({len(eight)}); the '
              f'planted clique {clique} drawn {hit} times (p {p_clique:.3e}) [{card}]')
        _hold_chi2('GraphGBS samples', stat, dof, bar)
        try:
            nx = importlib.import_module('networkx')
        except ImportError:
            print('GraphGBS graph_density: skipped, networkx is not installed here')
        else:
            dens = gbs.graph_density(nx.from_numpy_array(adj), six)
            top = next(iter(dens.items()), None)
            print(f'GraphGBS graph_density of the 6-click samples: densest {top}')
        out['threshold'] = dict(stats, measure_ms=ms, chi2=stat, dof=dof, clique_hits=hit)
    # pnrd on the 10-node subgraph: the table through hafnian_batch, by precision
    calls, tables = [], {}
    real = gp.hafnian_batch

    def counted(mats, loop=False):
        calls.append(tuple(mats.shape))
        return real(mats, loop)

    gp.hafnian_batch = counted
    try:
        with torch.no_grad():
            for dtype in ('complex128', 'complex64'):
                dqt.set_dtype(dtype)
                small = dqt.photonic.GraphGBS(adj[:GRAPH_SMALL, :GRAPH_SMALL], cutoff=2,
                                              mean_photon_num=GRAPH_SMALL, detector='pnrd',
                                              rng=np.random.default_rng(SEED))
                calls.clear()
                tables[dtype], stats = _cv_stats(lambda: small(is_prob=True))
                tables[dtype + ' calls'] = len(calls) // 3        # _cv_stats calls it thrice
                out[f'pnrd_{dtype}'] = stats
                for k, v in stats['launches'].items():
                    counts_all[k] = counts_all.get(k, 0) + v
    finally:
        gp.hafnian_batch = real
        dqt.set_dtype('complex64')
    ref = _by_state(tables['complex128'])
    got = _by_state(tables['complex64'])
    d = max(abs(got[k].item() - ref[k].item()) for k in ref)
    total = sum(v.item() for v in ref.values())
    print(f"GraphGBS {GRAPH_SMALL} nodes, pnrd, cutoff 2: {len(ref)} outcomes (sum {total:.6f}: "
          f"the cutoff drops the tail), {tables['complex128 calls']} hafnian_batch calls; "
          f"complex64 {_stats_text(out['pnrd_complex64'])}, complex128 "
          f"{_stats_text(out['pnrd_complex128'])}; max |d p| {d:.2e} [{card}]")
    if len(ref) != 1 << GRAPH_SMALL or tables['complex128 calls'] != GRAPH_SMALL + 1 \
            or not d <= PNRD_BAR or out['pnrd_complex64']['launches']:
        raise AssertionError(f'GraphGBS pnrd: {len(ref)} outcomes, '
                             f"{tables['complex128 calls']} calls, |d p| {d} > {PNRD_BAR}")
    out['pnrd_max_abs_err'] = d
    return counts_all, out


def _lossy_gbs(displaced: bool, seed: int):
    """Path (b)'s 14-mode threshold GBS with loss_db(3.0) on every mode."""
    cir = _gbs_circuit(GBS_BIG, displaced, np.random.default_rng(seed))
    for i in range(GBS_BIG):
        cir.loss_db(i, LOSS_DB)
    return cir


def check_lossy_gbs(card: str):
    """Phase 9i: path (b)'s 14-mode threshold GBS with 3 dB of loss on every
    mode, at complex128: the click table (12 batched K8 calls; displaced,
    12 batched K9 calls), sum 1 within 1e-6, measure(10^5 shots) by a
    chi-square against it; then homodyne conditioning of the undisplaced
    lossy state on 4 of its 14 modes with given outcomes, complex64
    against complex128."""
    import torch
    dqt = _pkg()[0]
    counts_all, out = {}, {}
    with torch.no_grad():
        with complex128():
            for displaced, hot in ((False, 'tor_dets_cuda_batched'),
                                   (True, 'tor_dets_quads_cuda_batched')):
                label = 'lossy GBS 14 modes' + (', displaced' if displaced else '')
                cir = _lossy_gbs(displaced, SEED + 11)
                table, stats = _cv_stats(lambda: cir(is_prob=True))
                total = torch.stack(list(table.values())).sum().item()
                gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
                samples, ms = _one_call_ms(lambda: cir.measure(shots=CV_SHOTS, generator=gen))
                stat, dof, bar = _dict_chi2(samples, table, CV_SHOTS)
                print(f'{label}, {LOSS_DB} dB: sum {total:.10f}; table {_stats_text(stats)}; '
                      f'measure({CV_SHOTS}) {ms:.1f} ms, chi-square {stat:.1f} on {dof} dof '
                      f'(bound {bar:.1f}) [{card}]')
                if stats['launches'] != {hot: GBS_BIG - 2} or not abs(total - 1) <= 1e-6:
                    raise AssertionError(f'{label}: launches {stats["launches"]}, sum {total}')
                _hold_chi2(label, stat, dof, bar)
                for k, v in stats['launches'].items():
                    counts_all[k] = counts_all.get(k, 0) + v
                out['displaced' if displaced else 'plain'] = dict(stats, measure_ms=ms, chi2=stat,
                                                                  dof=dof)
        conditioned = {}
        outcomes = np.random.default_rng(SEED + 12).normal(size=(len(HOMODYNE_WIRES), 2))
        for dtype in ('complex128', 'complex64'):
            dqt.set_dtype(dtype)
            try:
                state = _lossy_gbs(False, SEED + 11)()

                def condition(state=state):
                    for w, s in zip(HOMODYNE_WIRES, outcomes):
                        state = dqt.Homodyne(0.3 * w, GBS_BIG, w)(state, samples=s)
                    return state

                conditioned[dtype], stats = _cv_stats(condition)
            finally:
                dqt.set_dtype('complex64')
        errs = [rel_err(a.double(), b)[0] for a, b in zip(conditioned['complex64'],
                                                           conditioned['complex128'])]
        print(f'homodyne on modes {list(HOMODYNE_WIRES)} of the lossy state, given outcomes: '
              f'complex64 against complex128 cov {errs[0]:.2e}, mean {errs[1]:.2e}; '
              f'{_stats_text(stats)} [{card}]')
        if not (errs[0] <= HOMODYNE_COV_BAR and errs[1] <= HOMODYNE_MEAN_BAR):
            raise AssertionError(f'homodyne conditioning: {errs} above '
                                 f'{HOMODYNE_COV_BAR} / {HOMODYNE_MEAN_BAR}')
        out['homodyne'] = dict(stats, cov_rel_err=errs[0], mean_rel_err=errs[1])
    return counts_all, out


def borealis_tdm():
    """A Borealis-like source (Madsen et al., Nature 606, 75): one squeezed
    spatial mode through loops of 1, 6 and 36 time bins, each loop's
    (theta, phi) encoded per bin, homodyne x (the TDM API measures by
    homodyne where Borealis counts photons): 44 concurrent modes."""
    dqt = _pkg()[0]
    cir = dqt.QumodeCircuitTDM(1, 'vac')
    cir.s(0, r=1.0)
    for ntau in BOREALIS_LOOPS:
        cir.delay(0, ntau=ntau, convention='bs', encode=True)
    cir.homodyne_x(0)
    return cir


def cluster_tdm():
    """A 2-D cluster-state source (Asavanant et al., Science 366, 373): two
    squeezed spatial modes, one turned by pi / 2, a real balanced beam
    splitter (an EPR pair a step; ``bs_theta``'s fixed phase of pi / 2
    would align the two squeezings and entangle nothing), delays of 1 and
    12 bins (full swaps), x and p homodyne."""
    dqt = _pkg()[0]
    cir = dqt.QumodeCircuitTDM(2, 'vac')
    cir.s(0, r=1.0)
    cir.s(1, r=1.0)
    cir.r(0, [np.pi / 2])
    cir.bs([0, 1], [np.pi / 4, 0.0])
    for wire, ntau in enumerate(CLUSTER_DELAYS):
        cir.delay(wire, ntau=ntau, inputs=[np.pi / 2, 0.0])
    cir.homodyne_x(0)
    cir.homodyne_p(1)
    return cir


def _tdm_steps(cir, data, steps: int, gen, record: bool):
    """Run ``steps`` time steps one call each (data (B, steps, nfeat) or
    None); the last state, the covariance after each step when ``record``
    and every step's samples, (B, nwire, steps)."""
    import torch
    state, covs, samples = None, [], []
    for i in range(steps):
        state = cir(data=None if data is None else data[:, i:i + 1], state=state, nstep=1,
                    generator=gen)
        samples.append(cir.get_samples())
        if record:
            covs.append(state[0])
    return state, covs, torch.cat(samples, -1)


def check_tdm(card: str):
    """Phase 9j, time-domain multiplexing: the Borealis-like loops (data
    (64, 216, 6) from the seed, 216 steps, cov 88 x 88) and the 2-D
    cluster source (200 steps), each at complex64 against the port's
    complex128 run on the same generator seed. A conditioned covariance
    does not depend on the outcome: every step's covariance within
    TDM_COV_BAR. The normals are drawn in float64, so the samples and the
    means they feed back differ by rounding only: every step's samples and
    the last means within TDM_FEEDBACK_BAR of the run's largest |mean| or
    |sample|, and the feedback must have moved the means (the mean update
    itself is held to the JAX package by tests/test_torch_tdm_bosonic.py).
    ms per step, peak memory, the busy share (the device time of
    TDM_BUSY_STEPS steps over their share of the run's time)."""
    import torch
    dqt = _pkg()[0]
    data = np.random.default_rng(SEED + 13).uniform(
        0, 2 * np.pi, (BOREALIS_BATCH, BOREALIS_STEPS, 2 * len(BOREALIS_LOOPS)))
    out = {}
    with torch.no_grad():
        for label, build, feats, steps in (('borealis', borealis_tdm, data, BOREALIS_STEPS),
                                           ('cluster', cluster_tdm, None, CLUSTER_STEPS)):
            runs = {}
            for dtype in ('complex128', 'complex64'):
                dqt.set_dtype(dtype)
                try:
                    cir = build()
                    gen = torch.Generator(device='cuda').manual_seed(SEED)
                    torch.cuda.reset_peak_memory_stats()
                    (state, covs, samples), ms = _one_call_ms(
                        lambda: _tdm_steps(cir, feats, steps, gen, record=True))
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    runs[dtype] = (covs, state, samples, ms, peak)
                    if dtype == 'complex64':
                        # device time of the first steps over their share of
                        # the run's time (the profiler lengthens its window)
                        device_ms = _cuda_only_device_ms(
                            lambda: _tdm_steps(cir, feats, TDM_BUSY_STEPS, gen, record=False))
                        busy = device_ms / (ms * TDM_BUSY_STEPS / steps)
                finally:
                    dqt.set_dtype('complex64')
            cov_err = max(rel_err(a.double(), b)[0]
                          for a, b in zip(runs['complex64'][0], runs['complex128'][0]))
            # the means follow the samples: both against the run's largest
            # |mean| or |sample|
            mean_err = rel_err(runs['complex64'][1][1].double(), runs['complex128'][1][1])[1]
            mean_max = runs['complex128'][1][1].abs().max().item()
            sample_err = (runs['complex64'][2].double() - runs['complex128'][2]).abs().max().item()
            scale = max(mean_max, runs['complex128'][2].abs().max().item())
            ms64, ms128 = runs['complex64'][3], runs['complex128'][3]
            nmode = runs['complex64'][1][0].shape[-1] // 2
            print(f'TDM {label}: {nmode} concurrent modes, cov {tuple(runs["complex64"][1][0].shape)},'
                  f' {steps} steps: complex64 {ms64 / steps:.3f} ms a step ({ms64:.1f} ms, peak '
                  f'{runs["complex64"][4]:.3f} GiB, busy {100 * busy:.1f} %), complex128 '
                  f'{ms128 / steps:.3f} ms a step; every step\'s cov against complex128 '
                  f'{cov_err:.2e}; the last means max |d| {mean_err:.2e} (max |mean| '
                  f'{mean_max:.2e}), every step\'s samples max |d| {sample_err:.2e} (of '
                  f'{runs["complex64"][2].numel()}; scale {scale:.2e}) [{card}]')
            if not cov_err <= TDM_COV_BAR or not torch.isfinite(runs['complex64'][2]).all():
                raise AssertionError(f'TDM {label}: covariance {cov_err} > {TDM_COV_BAR}')
            if runs['complex64'][2].shape[-1] != steps or not mean_max > 1e-3 \
                    or not max(mean_err, sample_err) <= TDM_FEEDBACK_BAR * scale:
                raise AssertionError(f'TDM {label}: means {mean_err} / samples {sample_err} '
                                     f'above {TDM_FEEDBACK_BAR} x {scale}, or no feedback '
                                     f'(max |mean| {mean_max})')
            out[label] = dict(ms_per_step=ms64 / steps, ms_per_step_c128=ms128 / steps,
                              peak_gib=runs['complex64'][4], busy=busy, cov_rel_err=cov_err,
                              mean_abs_err=mean_err, sample_abs_err=sample_err,
                              feedback_scale=scale, modes=nmode)
    return {}, out


def bosonic_circuit():
    """Two cats (even and odd, r = 1.5) and a GKP state (epsilon 0.05, the
    weights above 0.1), two balanced beam splitters, homodyne x of mode 2."""
    dqt = _pkg()[0]
    cir = dqt.QumodeCircuit(3, backend='bosonic')
    cir.cat(0, r=1.5, theta=0.0, p=0)
    cir.cat(1, r=1.5, theta=0.0, p=1)
    cir.gkp(2, theta=0.0, phi=0.0, epsilon=0.05, amp_cutoff=0.1)
    cir.bs([0, 1], [np.pi / 4, 0.0])
    cir.bs([1, 2], [np.pi / 4, 0.0])
    cir.homodyne_x(2)
    return cir


def _marginal_bins(cov, mean, weight, edges):
    """Bin probabilities of p(x) = Re sum_k w_k N(x; mu_k, s_k^2) (complex
    means: the normal CDF continued analytically through erf), the tails
    beyond the edges as two more cells."""
    from scipy.special import erf
    s = np.sqrt(2 * cov)[:, None]
    cdf = 0.5 * (1 + erf((edges[None, :] - mean[:, None]) / s))
    inner = np.real(np.sum(weight[:, None] * np.diff(cdf, axis=1), 0))
    below = np.real(np.sum(weight * cdf[:, 0]))
    return np.concatenate([[below], inner, [1 - below - inner.sum()]])


def check_bosonic(card: str):
    """Phase 9k, the Bosonic backend at complex128: the cats and the GKP
    state combined (16 x the GKP's components), the beam splitters,
    measure_homodyne(1000 shots) through the conditional homodyne (the
    weights of every shot's state sum to 1), the Wigner function of mode
    0 on 100 x 100 points (its integral within 1e-3 of 1), the quadrature
    means and photon statistics, and the rejection sampler's draws of mode
    0's x (MARGINAL_SHOTS) against its marginal p(x) by a chi-square."""
    import torch
    dqt = _pkg()[0]
    out = {}
    with complex128(), torch.no_grad():
        cir = bosonic_circuit()
        gkp = cir._bosonic_states[2].ncomb
        state, stats = _cv_stats(cir)
        ncomb = state[2].shape[-1]
        wsum = state[2].sum().item()
        print(f'Bosonic: ncomb {ncomb} = 16 x {gkp} GKP components; forward '
              f'{_stats_text(stats)}; weights sum {wsum:.12f} [{card}]')
        if ncomb != 16 * gkp or not abs(wsum - 1) <= 1e-9:
            raise AssertionError(f'Bosonic state: {ncomb} components, weights sum {wsum}')
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        xs, hstats = _cv_stats(lambda: cir.measure_homodyne(shots=BOSONIC_SHOTS, generator=gen))
        weights = cir.state_measured[2].sum(-1)
        werr = (weights - 1).abs().max().item()
        print(f'Bosonic measure_homodyne({BOSONIC_SHOTS}): x of mode 2 mean '
              f'{xs.mean().item():.4f}, std {xs.std().item():.4f}; every shot\'s weights sum to '
              f'1 within {werr:.1e}; {_stats_text(hstats)} [{card}]')
        if xs.shape != (BOSONIC_SHOTS,) or not torch.isfinite(xs).all() or not werr <= 1e-9:
            raise AssertionError('Bosonic measure_homodyne: bad samples or weights')
        wig, wstats = _cv_stats(lambda: cir.wigner(0, npoints=WIGNER_POINTS, plot=False,
                                                    normalize=False))
        step = (20 / (WIGNER_POINTS - 1)) ** 2
        integral = wig.sum().item() * step
        qmean = cir.quadrature_mean().cpu().numpy().round(6).tolist()
        nmean, nvar = (t.cpu().numpy().round(6).tolist() for t in cir.photon_number_mean_var())
        print(f'Bosonic Wigner of mode 0 on {WIGNER_POINTS} x {WIGNER_POINTS}: integral '
              f'{integral:.6f}, min {wig.min().item():.4f}; {_stats_text(wstats)}; <x> {qmean}, '
              f'<n> {nmean}, Var n {nvar} [{card}]')
        if not abs(integral - 1) <= 1e-3:
            raise AssertionError(f'Bosonic Wigner function integrates to {integral}')
        from deepquantum_tpu_torch.photonic.measurement import sample_bosonic
        cov, mean, weight = (t[0] for t in state)
        draws, sstats = _cv_stats(lambda: sample_bosonic(
            cov[None, :, :1, :1], mean[None, :, :1].expand(MARGINAL_SHOTS, -1, -1, -1),
            weight[None], gen))
        edges = np.linspace(-9, 9, 61)
        probs = _marginal_bins(cov[:, 0, 0].cpu().numpy(), mean[:, 0, 0].cpu().numpy(),
                               weight.cpu().numpy(), edges)
        obs = np.histogram(draws[:, 0].cpu().numpy(), np.concatenate([[-np.inf], edges,
                                                                       [np.inf]]))[0]
        exp = probs * MARGINAL_SHOTS
        big = exp >= 5
        stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
        dof = int(big.sum()) - 1
        bar = dof + 6 * np.sqrt(2 * dof)
        print(f'Bosonic rejection sampler, x of mode 0: {MARGINAL_SHOTS} draws, chi-square '
              f'{stat:.1f} on {dof} dof (bound {bar:.1f}); min bin probability '
              f'{probs.min():.2e}; {_stats_text(sstats)} [{card}]')
        _hold_chi2('Bosonic marginal', stat, dof, bar)
        out = dict(ncomb=ncomb, forward=stats, measure_homodyne=hstats, wigner=wstats,
                   sampler=sstats, wigner_integral=integral, chi2=stat, dof=dof)
    return {}, out


# ------------------------------------------------ the Fock-tensor engine
QNN_MODES, QNN_CUTOFF, QNN_LAYERS, QNN_STEPS, QNN_LR = 7, 10, 2, 3, 0.05
FDM_MODES, FDM_CUTOFF, FDM_LOSS_DB = 4, 8, 3.0
FOCK_SHOTS = 100_000
FMPS_EXACT_MODES, FMPS_EXACT_CHI = 8, 256      # chi = 4^4: exact at cutoff 4
FMPS_MODES, FMPS_CHI, FMPS_CUTOFF, FMPS_SHOTS = 16, 32, 4, 1000
FOCK_HOMODYNE_SHOTS = 10_000
# complex64 against complex128 on the same circuit: the state over its
# largest |amplitude|, the value relative, the gradient over its largest
# |component| (the CPU rehearsal at 3 modes, cutoff 6 read 1e-7 / 1e-7 / 1e-6)
FOCK_STATE_BAR, FOCK_VALUE_BAR, FOCK_GRAD_BAR = 1e-5, 1e-5, 1e-4
# the MPS at full bond against the dense tensor, both complex64
FMPS_BAR = 1e-5


def cvqnn_layer(cir, nmode: int, rng) -> None:
    """Killoran et al.'s CV-QNN layer (arXiv:1806.06871), trainable, values
    from rng: an interferometer (a phase on every mode, beam splitters in
    nmode brick columns, a phase on every mode), squeezing on every mode,
    a second interferometer, displacement on every mode, Kerr on every
    mode; 5 nmode + nmode (nmode - 1) operations (91 at 7 modes)."""
    def mesh():
        for w in range(nmode):
            cir.add_op('PhaseShift', w, [rng.uniform(0, 2 * np.pi)], requires_grad=True)
        for col in range(nmode):
            for w in range(col % 2, nmode - 1, 2):
                cir.add_op('BeamSplitter', [w, w + 1],
                           [rng.uniform(0, np.pi / 2), rng.uniform(0, 2 * np.pi)],
                           requires_grad=True)
        for w in range(nmode):
            cir.add_op('PhaseShift', w, [rng.uniform(0, 2 * np.pi)], requires_grad=True)

    mesh()
    for w in range(nmode):
        cir.add_op('Squeezing', w, [rng.uniform(0, 0.2), rng.uniform(0, 2 * np.pi)],
                   requires_grad=True)
    mesh()
    for w in range(nmode):
        cir.add_op('Displacement', w, [rng.uniform(0, 0.3), rng.uniform(0, 2 * np.pi)],
                   requires_grad=True)
    for w in range(nmode):
        cir.add_op('Kerr', w, [rng.uniform(-0.1, 0.1)], requires_grad=True)


def cvqnn_circuit(nmode: int, cutoff: int, layers: int, seed: int, **kwargs):
    """A CV-QNN of ``layers`` layers on the vacuum, Fock tensor mode."""
    dqt = _pkg()[0]
    cir = dqt.QumodeCircuit(nmode, init_state='vac', cutoff=cutoff, basis=False, **kwargs)
    rng = np.random.default_rng(seed)
    for _ in range(layers):
        cvqnn_layer(cir, nmode, rng)
    return cir


def fock_step(cir, p):
    """The value sum <n> of the circuit's state at parameters p and its
    gradient."""
    p = p.detach().requires_grad_()
    cir(params=p)
    value = cir.photon_number_mean_var()[0].sum()
    value.backward()
    return value.detach(), p.grad


def _sgd(cir, p, steps: int):
    """``steps`` SGD steps from p: the losses before each update, the step
    times (CUDA events) and the final parameters."""
    losses, times = [], []
    for _ in range(steps):
        (value, grad), ms = _one_call_ms(lambda: fock_step(cir, p))
        losses.append(value.item())
        times.append(ms)
        p = (p - QNN_LR * grad).detach()
    return losses, times, p


def _fock_close(label: str, got, ref, bar: float) -> float:
    err = (got.to(ref.dtype) - ref).abs().max().item() / ref.abs().max().item()
    if not err <= bar:
        raise AssertionError(f'{label}: complex64 off complex128 by {err} (bar {bar})')
    return err


def _build_and_contract_ms(cir, p):
    """Each between CUDA events: building every Fock matrix of one forward
    as the forward does (a gate family in one call), building them one gate
    at a time, and contracting the prebuilt ones."""
    from deepquantum_tpu_torch.ops.apply import evolve_state
    c, n = cir.cutoff, cir.nmode
    full = cir._full_params(p)
    mats, build_ms = _one_call_ms(lambda: cir._fock_matrices(full))
    _, one_by_one_ms = _one_call_ms(lambda: [op.fock(full, c) for op in cir.operators])
    x0 = cir._fock_input(None)

    def contract():
        x = x0
        for op, m in zip(cir.operators, mats):
            x = evolve_state(x, m, n, list(op.wires), c)
        return x

    _, contract_ms = _one_call_ms(contract)
    return build_ms, one_by_one_ms, contract_ms


def check_fock_qnn(card: str):
    """Phase 9l, the CV-QNN training step on Fock tensors at full width:
    2 layers on 7 modes at cutoff 10 (10^7 amplitudes, 182 operations), the
    value and gradient of sum <n>, then three SGD steps; complex64 against
    the port's complex128 run on the card (state, value, gradient, the
    three losses); the step's time, busy share and peak memory, and the
    time of building the Fock matrices (a gate family a call, as the
    forward does, and one gate a call) against contracting them. Returns
    the complex64 circuit (its state is 9o's)."""
    import torch
    out = {}
    with complex128():
        ref = cvqnn_circuit(QNN_MODES, QNN_CUTOFF, QNN_LAYERS, SEED)
        p0 = ref.params.detach()
        with torch.no_grad():
            state_ref = ref()
        torch.cuda.reset_peak_memory_stats()
        (value_ref, grad_ref), ms_ref = _one_call_ms(lambda: fock_step(ref, p0))
        peak_ref = torch.cuda.max_memory_allocated() / 2 ** 30
        losses_ref, _, _ = _sgd(ref, p0, QNN_STEPS)
    del ref
    torch.cuda.empty_cache()
    cir = cvqnn_circuit(QNN_MODES, QNN_CUTOFF, QNN_LAYERS, SEED)
    p = p0.to(torch.float32)
    with torch.no_grad():
        state, fwd = _cv_stats(lambda: cir(params=p))
    (value, grad), stats = _cv_stats(lambda: fock_step(cir, p))
    losses, times, p_end = _sgd(cir, p, QNN_STEPS)
    more = _sgd(cir, p_end, 2)[1]
    with torch.no_grad():
        build_ms, one_by_one_ms, contract_ms = _build_and_contract_ms(cir, p)
        cir(params=p)                                  # 9o's state: the first parameters
    out = dict(ops=len(cir.operators), amplitudes=state.numel(), forward=fwd, step=stats,
               step_ms=float(np.median(times + more)), complex128_step_ms=ms_ref,
               complex128_peak_gib=round(peak_ref, 3), build_ms=build_ms,
               build_one_by_one_ms=one_by_one_ms, contract_ms=contract_ms,
               value=value.item(), losses=losses)
    out['state_err'] = _fock_close('9l state', state, state_ref, FOCK_STATE_BAR)
    out['value_err'] = abs(value.item() - value_ref.item()) / abs(value_ref.item())
    out['grad_err'] = _fock_close('9l gradient', grad, grad_ref, FOCK_GRAD_BAR)
    out['loss_err'] = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_ref))
    print(f"Fock CV-QNN {QNN_MODES} modes, cutoff {QNN_CUTOFF}, {QNN_LAYERS} layers: "
          f"{out['ops']} ops, {out['amplitudes']} amplitudes, sum <n> {value.item():.6f}; "
          f"forward {_stats_text(fwd)}; value and gradient {_stats_text(stats)}; SGD steps "
          f"{[round(t, 1) for t in times + more]} ms (median {out['step_ms']:.1f}), losses "
          f"{[round(v, 6) for v in losses]}; building the Fock matrices {build_ms:.1f} ms "
          f"(a family a call; one gate a call {one_by_one_ms:.1f} ms), contracting them "
          f"{contract_ms:.1f} ms; complex128 step {ms_ref:.1f} ms, peak "
          f"{peak_ref:.2f} GiB; complex64 off complex128: state {out['state_err']:.1e}, value "
          f"{out['value_err']:.1e}, gradient {out['grad_err']:.1e}, losses "
          f"{out['loss_err']:.1e} [{card}]")
    if not (out['value_err'] <= FOCK_VALUE_BAR and out['loss_err'] <= FOCK_VALUE_BAR):
        raise AssertionError(f"9l value off complex128 by {out['value_err']} / "
                             f"{out['loss_err']}")
    if stats['launches'] or fwd['launches'] or not torch.isfinite(grad).all():
        raise AssertionError(f"9l: kernel launches {stats['launches']} or a non-finite gradient")
    return {}, out, cir


def _fock_dm(seed: int):
    cir = cvqnn_circuit(FDM_MODES, FDM_CUTOFF, 1, seed, den_mat=True)
    for w in range(FDM_MODES):
        cir.loss_db(w, FDM_LOSS_DB)
    return cir


def check_fock_dm(card: str):
    """Phase 9m, a lossy Fock density matrix: one CV-QNN layer on 4 modes at
    cutoff 8 (rho has 8^8 entries), then loss_db(3) on every mode: the
    forward, the value and gradient of sum <n>, quadrature_mean, wigner(0)
    on 100 x 100 points, measure(10^5) by a chi-square against the
    diagonal; complex64 against complex128."""
    import torch
    with complex128():
        ref = _fock_dm(SEED + 11)
        p0 = ref.params.detach()
        with torch.no_grad():
            rho_ref = ref()
            quad_ref = ref.quadrature_mean()
            wig_ref = ref.wigner(0, npoints=WIGNER_POINTS, plot=False)
        value_ref, grad_ref = fock_step(ref, p0)
    del ref
    cir = _fock_dm(SEED + 11)
    p = p0.to(torch.float32)
    with torch.no_grad():
        rho, fwd = _cv_stats(lambda: cir(params=p))
    (value, grad), stats = _cv_stats(lambda: fock_step(cir, p))
    with torch.no_grad():
        cir(params=p)
        quad, qstats = _cv_stats(cir.quadrature_mean)
        wig, wstats = _cv_stats(lambda: cir.wigner(0, npoints=WIGNER_POINTS, plot=False))
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        counts, mstats = _cv_stats(lambda: cir.measure(shots=FOCK_SHOTS, generator=gen))
    c, n = FDM_CUTOFF, FDM_MODES
    diag = rho.reshape(c ** n, c ** n).diagonal().real.double().cpu().numpy()
    stat, dof, bar = _dict_chi2(counts, _fock_table(diag, c, n), FOCK_SHOTS)
    trace = float(diag.sum())
    step = (20 / (WIGNER_POINTS - 1)) ** 2
    out = dict(entries=rho.numel(), trace=trace, forward=fwd, step=stats, quadrature=qstats,
               wigner=wstats, measure=mstats, chi2=stat, dof=dof, outcomes=len(counts),
               wigner_integral=wig.sum().item() * step)
    out['rho_err'] = _fock_close('9m rho', rho, rho_ref, FOCK_STATE_BAR)
    out['value_err'] = abs(value.item() - value_ref.item()) / abs(value_ref.item())
    out['grad_err'] = _fock_close('9m gradient', grad, grad_ref, FOCK_GRAD_BAR)
    out['quad_err'] = (quad.double() - quad_ref).abs().max().item()
    out['wigner_err'] = _fock_close('9m Wigner', wig, wig_ref, FOCK_STATE_BAR)
    print(f"Fock rho {n} modes, cutoff {c}, loss {FDM_LOSS_DB} dB a mode: {rho.numel()} "
          f"entries, trace {trace:.6f}, sum <n> {value.item():.6f}; forward {_stats_text(fwd)}; "
          f"value and gradient {_stats_text(stats)}; quadrature_mean {_stats_text(qstats)}; "
          f"wigner(0) {WIGNER_POINTS} x {WIGNER_POINTS} {_stats_text(wstats)}, integral "
          f"{out['wigner_integral']:.6f}; measure({FOCK_SHOTS}) {_stats_text(mstats)}, chi-square "
          f"{stat:.1f} on {dof} dof (bound {bar:.1f}); complex64 off complex128: rho "
          f"{out['rho_err']:.1e}, value {out['value_err']:.1e}, gradient {out['grad_err']:.1e}, "
          f"<x> {out['quad_err']:.1e}, Wigner {out['wigner_err']:.1e} [{card}]")
    _hold_chi2('9m samples', stat, dof, bar)
    if not (out['value_err'] <= FOCK_VALUE_BAR and out['quad_err'] <= FOCK_STATE_BAR
            and abs(out['wigner_integral'] - trace) <= 1e-3):
        raise AssertionError(f'9m: value {out["value_err"]}, <x> {out["quad_err"]}, Wigner '
                             f'integral {out["wigner_integral"]} against the trace {trace}')
    if stats['launches'] or fwd['launches']:
        raise AssertionError(f"9m: kernel launches {stats['launches']}")
    return {}, out


def _fock_table(diag: np.ndarray, c: int, n: int) -> dict:
    """{FockState: probability} over every outcome of the diagonal."""
    dqt = _pkg()[0]
    keys = np.stack(np.unravel_index(np.arange(c ** n), (c,) * n), -1)
    return {dqt.FockState(list(k), n, c): float(p) for k, p in zip(keys, diag)}


def check_fock_mps(card: str):
    """Phase 9n, the Fock MPS: one CV-QNN layer on 8 modes at cutoff 4 with
    chi = 256 (exact) against the dense tensor of 9l's code path, both
    complex64, with its busy share; then 16 modes at cutoff 4 with chi = 32:
    the forward and measure(1000), their times and factorisation calls."""
    import torch
    from deepquantum_tpu_torch.mps import full_tensor
    out = {}
    with torch.no_grad():
        mps = cvqnn_circuit(FMPS_EXACT_MODES, FMPS_CUTOFF, 1, SEED + 12, mps=True,
                            chi=FMPS_EXACT_CHI)
        dense = cvqnn_circuit(FMPS_EXACT_MODES, FMPS_CUTOFF, 1, SEED + 12)
        psi = dense().reshape(-1)
        sites, exact = _cv_stats(mps)
        err = _fock_close('9n MPS at full bond', full_tensor(sites),
                          psi / torch.linalg.vector_norm(psi), FMPS_BAR)
        big = cvqnn_circuit(FMPS_MODES, FMPS_CUTOFF, 1, SEED + 13, mps=True, chi=FMPS_CHI)
        facts = {}
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with count_factorisations(facts):
            sites, ms_first = _one_call_ms(big)
        _, ms_again = _one_call_ms(big)
        # no profiler window here: over this forward's 1458 factorisations
        # one took ~50 s on an H100; the busy share is the 8-mode one's
        fwd = dict(ms=ms_first, again_ms=ms_again,
                   launches={k: v for k, v in read_counts().items() if v},
                   peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3))
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        counts, ms = _one_call_ms(lambda: big.measure(shots=FMPS_SHOTS, generator=gen))
    bonds = [t.shape[-1] for t in sites]
    total = sum(counts.values())
    out = dict(exact=exact, exact_err=err, forward=fwd, measure_ms=ms, bonds=bonds,
               factorisations=facts, outcomes=len(counts),
               ops=len(big.operators))
    print(f'Fock MPS {FMPS_EXACT_MODES} modes, cutoff {FMPS_CUTOFF}, chi {FMPS_EXACT_CHI}: '
          f'{_stats_text(exact)}, off the dense tensor {err:.1e}; {FMPS_MODES} modes, chi '
          f"{FMPS_CHI}, {len(big.operators)} ops: forward {ms_first:.1f} ms (again "
          f"{ms_again:.1f}), peak {fwd['peak_gib']} GiB, bonds {bonds}, "
          f"factorisations in the first forward (the families' split bases included) "
          f"{out['factorisations']}; measure({FMPS_SHOTS}) {ms:.1f} ms, "
          f'{len(counts)} outcomes [{card}]')
    if total != FMPS_SHOTS or max(bonds) > FMPS_CHI or fwd['launches'] or exact['launches'] \
            or not all(torch.isfinite(t).all() for t in sites):
        raise AssertionError(f'9n: {total} shots, bonds {bonds}, launches {fwd["launches"]}')
    return {}, out


def check_fock_homodyne(card: str, qnn):
    """Phase 9o, homodyne on Fock tensors: measure_homodyne(10^4) on mode 0
    of 9l's state by a chi-square against its grid pdf; a conditional
    homodyne(0) inside a 4-mode circuit with given outcomes, complex64
    against complex128; per-forward noise from an explicit generator,
    bitwise the same over two runs with one seed."""
    import torch
    from deepquantum_tpu_torch.photonic import measurement as meas
    from deepquantum_tpu_torch.photonic.wigner import reduced_dm
    out = {}
    with torch.no_grad():
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        xs, hstats = _cv_stats(lambda: qnn.measure_homodyne(shots=FOCK_HOMODYNE_SHOTS,
                                                            wires=0, generator=gen))
        pdf = meas.homodyne_pdf(reduced_dm(qnn.state, 0, qnn.nmode, qnn.cutoff))[0]
        grid = meas.homodyne_grid('cpu').numpy()
        obs = np.bincount(np.searchsorted(grid, xs.cpu().numpy()), minlength=len(grid))
        pdf = pdf.double().cpu().numpy()
        exp = FOCK_HOMODYNE_SHOTS * pdf
        big = exp >= 5
        stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
        stat += float((obs[~big].sum() - exp[~big].sum()) ** 2 / max(exp[~big].sum(), 1e-300))
        dof = int(big.sum())
        bar = dof + 6 * np.sqrt(2 * dof)
        states = {}
        for dtype in ('complex128', 'complex64'):
            _pkg()[0].set_dtype(dtype)
            cir = cvqnn_circuit(4, FDM_CUTOFF, 1, SEED + 14)
            cir.homodyne(0, phi=0.5)
            state = cir()
            states[dtype], cstats = _cv_stats(lambda: cir.measurements[0](state, samples=[0.4]))
            cond = cir.measure_homodyne(shots=100, generator=gen)
        _pkg()[0].set_dtype('complex64')
        cerr = _fock_close('9o conditional homodyne', states['complex64'], states['complex128'],
                           FOCK_STATE_BAR)
        noisy = cvqnn_circuit(4, FDM_CUTOFF, 1, SEED + 15, noise=True, noise_per_forward=True)
        runs = [noisy(noise_generator=torch.Generator(device='cuda').manual_seed(SEED))
                for _ in range(2)]
        other = noisy(noise_generator=torch.Generator(device='cuda').manual_seed(SEED + 1))
    same, moved = torch.equal(runs[0], runs[1]), not torch.equal(runs[0], other)
    out = dict(measure=hstats, chi2=stat, dof=dof, conditional=cstats, conditional_err=cerr,
               mean_x=xs.mean().item(), noise_bitwise=same, noise_moves=moved)
    print(f'Fock homodyne: measure_homodyne({FOCK_HOMODYNE_SHOTS}) on mode 0 of 9l\'s state '
          f'{_stats_text(hstats)}, mean {xs.mean().item():.4f} (<x> '
          f'{qnn.quadrature_mean(0).item():.4f}), chi-square {stat:.1f} on {dof} dof (bound '
          f'{bar:.1f}); conditional homodyne(0), 4 modes: {_stats_text(cstats)}, complex64 off '
          f'complex128 {cerr:.1e}, 100 conditional shots {tuple(cond.shape)}; noise per forward: '
          f'one seed bitwise {same}, another seed differs {moved} [{card}]')
    _hold_chi2('9o homodyne samples', stat, dof, bar)
    if not (same and moved) or xs.shape != (FOCK_HOMODYNE_SHOTS,):
        raise AssertionError(f'9o: noise bitwise {same}, moved {moved}, shape {xs.shape}')
    return {}, out


# ------------------------------------------------- the qubit toolchain
TOOL_N = 18                       # 9p: the class-built bench ansatz
CUT_HALF = 12                     # 9q: two halves of the bench ansatz, n = 24
CUT_BUSY_TERMS = 4
MBQC_N = 5                        # 9r: random circuits of the MBQC family
MBQC_MIN_NODES = 20
MBQC_CIRCUITS = 2
MBQC_SEEDS = (0, 1, 2)
OPT_N = 12                        # 9s: the optimizers on the n=12 bench loss
OPT_SPSA_STEPS = 10
OPT_FOURIER_STEPS = 3


def class_bench(n: int, layers: int = LAYERS):
    """The bench ansatz from the class-style API: per layer an RxLayer, an
    RzLayer, an RxLayer and a CnotRing; X string on all wires."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(n)
    for _ in range(layers):
        for layer in (dqt.RxLayer, dqt.RzLayer, dqt.RxLayer):
            cir.add(layer(n))
        cir.add(dqt.CnotRing(n))
    cir.observable(list(range(n)), basis='x' * n)
    return cir


def _class_order(n: int, layers: int = LAYERS) -> list:
    """For each parameter of class_bench, its index in bench_circuit (which
    walks rx, rz, rx wire by wire)."""
    return [l * 3 * n + i * 3 + g for l in range(layers) for g in range(3) for i in range(n)]


def check_class_api_qasm(card: str, n: int = TOOL_N):
    """Phase 9p, the class-style API and QASM at full width: the bench
    ansatz at n=18, 5 layers, built from RxLayer / RzLayer / CnotRing with
    the sugar-built circuit's parameters, on the card: state and <X...X>
    against the sugar-built circuit (1e-6), the gradient (1e-5); then
    qasm3() and qasm3_to_cir of its text, the imported state against the
    class-built one (1e-5); the export and import times."""
    import torch
    dqt = _pkg()[0]
    sugar = bench_circuit(n)
    cls = class_bench(n)
    order = _class_order(n)
    cls._pvals = [sugar._pvals[i] for i in order]
    cls._touch()
    if cls.npara != sugar.npara or cls.device.type != 'cuda':
        raise AssertionError(f'9p: {cls.npara} parameters on {cls.device}')
    with torch.no_grad():
        reset_counts()
        state = cls.forward().clone()
        e = cls.expectation()
        torch.cuda.synchronize()
        counts = read_counts()
        ref_state = sugar.forward().clone()
        ref_e = sugar.expectation()
    loss, grad = grad_step(cls, cls.params.requires_grad_(), update=False)
    ref_loss, ref_grad = grad_step(sugar, sugar.params.requires_grad_(), update=False)
    d_state = (state - ref_state).abs().max().item()
    d_e = abs(e.item() - ref_e.item())
    d_grad = (grad - ref_grad[order]).abs().max().item()
    text, export_ms = _one_call_ms(cls.qasm3)
    back, import_ms = _one_call_ms(lambda: dqt.qasm3_to_cir(text))
    with torch.no_grad():
        back_state = back.forward()
    d_back = (back_state - state).abs().max().item()
    out = dict(launches={k: v for k, v in counts.items() if v}, state_err=d_state, value_err=d_e,
               grad_err=d_grad, qasm3_chars=len(text), export_ms=export_ms, import_ms=import_ms,
               roundtrip_err=d_back, value=e.item())
    print(f'class API n={n}, {LAYERS} layers: <X..X> {e.item():.8f} (sugar {ref_e.item():.8f}), '
          f'state max|d| {d_state:.2e}, |d value| {d_e:.2e}, gradient max|d| {d_grad:.2e}, '
          f'launches {out["launches"]}; qasm3() {len(text)} characters in {export_ms:.2f} ms, '
          f'qasm3_to_cir {import_ms:.2f} ms, imported state max|d| {d_back:.2e} [{card}]')
    if not (d_state <= 1e-6 and d_e <= 1e-6 and d_grad <= 1e-5 and d_back <= 1e-5):
        raise AssertionError(f'9p: {out}')
    if back.device.type != 'cuda' or counts['window_chain_fwd'] != 2:
        raise AssertionError(f'9p: imported on {back.device}, launches {counts}')
    return counts, out


def cut_circuit(half: int = CUT_HALF, layers: int = LAYERS, cut: bool = True):
    """Two halves of the bench ansatz (wires 0..h-1 and h..2h-1, rx, rz, rx
    per wire and a CNOT ring per layer) joined by cnot(h-1, h) before and
    cnot(h, h-1) after them; with ``cut`` wire h is cut after the first
    and wire h-1 before the second, which leaves two fragments of h + 1
    wires. Z Z on the wires h-1 and h that cross (after five random layers
    a Pauli string over more wires reads ~1e-4: 9q holds the sum and prints
    the sum of the terms' magnitudes beside it)."""
    dqt = _pkg()[0]
    n = 2 * half
    cir = dqt.QubitCircuit(n)
    cir.cnot(half - 1, half)
    if cut:
        cir.cut(half)
    for lo, hi in ((0, half - 1), (half, n - 1)):
        for _ in range(layers):
            for i in range(lo, hi + 1):
                cir.rx(i)
                cir.rz(i)
                cir.rx(i)
            cir.cnot_ring(minmax=[lo, hi])
    if cut:
        cir.cut(half - 1)
    cir.cnot(half, half - 1)
    cir.observable([half - 1, half], basis='zz')
    cir.init_para(SEED + 13)
    return cir


def _reconstruct(sub: dict, coeffs: list):
    """(sum_k coeff_k prod_fragments <O>_k, sum_k |that term|), each
    subcircuit's forward and expectation on its device."""
    import torch
    terms = []
    for k, coeff in enumerate(coeffs):
        prod = torch.ones((), dtype=torch.float64, device='cuda')
        for subs in sub.values():
            if subs[k].observables:
                subs[k].forward()
                prod = prod * subs[k].expectation().prod().double()
        terms.append(coeff * prod)
    terms = torch.stack(terms)
    return terms.sum().item(), terms.abs().sum().item()


def check_cutting(card: str):
    """Phase 9q, circuit cutting: cut_circuit at n=24 (two 12-wire halves of
    the bench ansatz, 5 layers, two wire cuts) -> 8^2 = 64 terms, 128
    subcircuits of 13 wires on the card; the reconstructed <Z Z> of the
    crossing wires against the uncut circuit on the card at complex64 and at complex128
    (1e-5); the host time to build the subexperiments, the time to run
    them, their K1 / K2 / K3 launches and the device's busy share over the
    first CUT_BUSY_TERMS terms."""
    import torch
    dqt = _pkg()[0]
    cut = cut_circuit()
    (sub, coeffs), build_ms = _one_call_ms(cut.get_subexperiments)
    widths = sorted({c.nqubit for s in sub.values() for c in s})
    nsub = sum(len(s) for s in sub.values())
    if len(coeffs) != 64 or nsub != 128 or widths != [CUT_HALF + 1]:
        raise AssertionError(f'9q: {len(coeffs)} terms, {nsub} subcircuits of widths {widths}')
    if any(c.device.type != 'cuda' for s in sub.values() for c in s):
        raise AssertionError('9q: a subcircuit left the card')
    # the busy share from CUT_BUSY_TERMS terms: a profiler window over all 64
    # terms (~14 000 launches) holds the card for over a minute
    part = {label: subs[:CUT_BUSY_TERMS] for label, subs in sub.items()}

    def run_part():
        return _reconstruct(part, coeffs[:CUT_BUSY_TERMS])

    with torch.no_grad():
        reset_counts()
        (value, scale), run_ms = _one_call_ms(lambda: _reconstruct(sub, coeffs))
        counts = read_counts()
        _, part_ms = _one_call_ms(run_part)
        device_ms = _cuda_only_device_ms(run_part)
        uncut = cut_circuit(cut=False)
        want64 = uncut.expectation()[0].item()
    del uncut
    with complex128(), torch.no_grad():
        uncut = cut_circuit(cut=False)
        want128 = uncut.expectation()[0].item()
    del uncut
    d64, d128 = abs(value - want64), abs(value - want128)
    k123 = {k: counts[k] for k in ('planar_apply', 'window_apply', 'window_chain_fwd')}
    out = dict(terms=len(coeffs), subcircuits=nsub, widths=widths, value=value, abs_terms=scale,
               uncut64=want64,
               uncut128=want128, err64=d64, err128=d128, build_ms=build_ms, run_ms=run_ms,
               part_ms=part_ms, busy=round(device_ms / part_ms, 4), launches=k123)
    print(f'cutting n={2 * CUT_HALF} ({LAYERS} layers a half, 2 wire cuts): {len(coeffs)} terms, '
          f'{nsub} subcircuits of {widths} wires, built in {build_ms:.1f} ms (host), run in '
          f'{run_ms:.1f} ms, launches K1 {k123["planar_apply"]}, K2 {k123["window_apply"]}, K3 '
          f'{k123["window_chain_fwd"]}; {CUT_BUSY_TERMS} terms in {part_ms:.1f} ms, busy '
          f'{100 * out["busy"]:.1f} %; reconstructed <ZZ> {value:.8f} (sum of |terms| '
          f'{scale:.6f}), uncut {want64:.8f} '
          f'(complex128 {want128:.8f}), |d| {d64:.2e} / {d128:.2e} [{card}]')
    if not (d64 <= 1e-5 and d128 <= 1e-5):
        raise AssertionError(f'9q: reconstruction off the uncut circuit: {out}')
    if sum(k123.values()) == 0:
        raise AssertionError(f'9q: the subexperiments launched no kernel: {counts}')
    return counts, out


def mbqc_circuit(seed: int, n: int = MBQC_N):
    """A circuit of the MBQC random family (rx on every wire, a cnot, rz on
    every wire, a cnot, h on wire 0), angles and cnot pairs from ``seed``."""
    dqt = _pkg()[0]
    rng = np.random.default_rng(seed)
    cir = dqt.QubitCircuit(n)
    for i in range(n):
        cir.rx(i, inputs=float(rng.random() * 2 * np.pi))
    cir.cnot(*(int(w) for w in rng.choice(n, 2, replace=False)))
    for i in range(n):
        cir.rz(i, inputs=float(rng.random() * 2 * np.pi))
    cir.cnot(*(int(w) for w in rng.choice(n, 2, replace=False)))
    cir.h(0)
    return cir


def _first_graph_nodes(pattern) -> int:
    """The nodes of the graph state the first measurement of a standard
    pattern materialises: the component of its node in the entanglement
    graph."""
    parent = {}

    def find(a):
        parent.setdefault(a, a)
        while parent[a] != a:
            a = parent[a]
        return a

    for c in pattern.commands:
        if type(c).__name__ == 'Entanglement':
            parent[find(c.nodes[0])] = find(c.nodes[1])
    first = next(c.nodes[0] for c in pattern.commands if type(c).__name__ == 'Measurement')
    root = find(first)
    return sum(1 for v in list(parent) if find(v) == root)


@contextlib.contextmanager
def _largest_graph_state(record: list):
    """Record the size of every graph state a pattern materialises."""
    from deepquantum_tpu_torch.mbqc.state import SubGraphState
    fget = SubGraphState.full_state.fget

    def spy(self):
        out = fget(self)
        record.append(out.numel())
        return out

    SubGraphState.full_state = property(spy)
    try:
        yield record
    finally:
        SubGraphState.full_state = property(fget)


def check_mbqc(card: str):
    """Phase 9r, MBQC on the card at complex128: QubitCircuit.pattern() of
    random 5-qubit circuits of the MBQC family, drawn until the standard
    pattern's first measurement materialises a graph state of >= 20 nodes
    (2^20+ amplitudes); each run unstandardised and standardised at three
    generator seeds, the output state's overlap with the circuit's state
    on the card >= 1 - 1e-8; nodes, the largest state, ms per pattern and
    the busy share of a standard run."""
    import torch
    rows = []
    seed = SEED + 14
    with complex128(), torch.no_grad():
        while len(rows) < MBQC_CIRCUITS:
            seed += 1
            cir = mbqc_circuit(seed)
            probe = cir.pattern()
            probe.standardize()
            if _first_graph_nodes(probe) < MBQC_MIN_NODES:
                continue
            target = cir.forward().reshape(-1)
            row = dict(seed=seed, nodes=len({v for c in probe.commands for v in c.nodes}),
                       first_graph_nodes=_first_graph_nodes(probe), runs=[])
            for standard in (False, True):
                for gen_seed in MBQC_SEEDS:
                    gen = torch.Generator(device='cuda').manual_seed(gen_seed)
                    pat = cir.pattern(generator=gen)
                    if standard:
                        pat.standardize()
                    sizes = []
                    with _largest_graph_state(sizes):
                        graph, ms = _one_call_ms(pat)
                    out = graph.full_state.reshape(-1)
                    if out.device.type != 'cuda' or out.dtype != torch.complex128:
                        raise AssertionError(f'9r: output on {out.device}, {out.dtype}')
                    overlap = ((out.conj() @ target).abs()
                               / (torch.linalg.vector_norm(out) * torch.linalg.vector_norm(target)))
                    row['runs'].append(dict(standard=standard, gen_seed=gen_seed, ms=ms,
                                            largest=max(sizes), overlap=overlap.item()))
            pat = cir.pattern(generator=torch.Generator(device='cuda').manual_seed(0))
            pat.standardize()
            _, wall = _one_call_ms(pat)
            row['busy'] = round(_cuda_only_device_ms(pat) / wall, 4)
            rows.append(row)
    for row in rows:
        std = [r for r in row['runs'] if r['standard']]
        raw = [r for r in row['runs'] if not r['standard']]
        print(f"MBQC circuit seed {row['seed']}: {row['nodes']} nodes, the standard pattern's "
              f"first graph state {row['first_graph_nodes']} nodes; largest state "
              f"{max(r['largest'] for r in std)} amplitudes standardised, "
              f"{max(r['largest'] for r in raw)} not; ms per pattern "
              f"{[round(r['ms'], 2) for r in std]} standardised, "
              f"{[round(r['ms'], 2) for r in raw]} not; min overlap "
              f"{min(r['overlap'] for r in row['runs']):.12f}; busy {100 * row['busy']:.1f} % "
              f"of a standard run{' (host-bound)' if row['busy'] < 0.5 else ''} [{card}]")
        if min(r['overlap'] for r in row['runs']) < 1 - 1e-8:
            raise AssertionError(f'9r: a pattern output is off the circuit state: {row}')
        if max(r['largest'] for r in std) < 1 << MBQC_MIN_NODES:
            raise AssertionError(f'9r: the largest graph state is small: {row}')
    return {}, rows


def check_optimizers(card: str, n: int = OPT_N):
    """Phase 9s, the gradient-free optimizers on the card: the n=12 bench
    loss <X...X> (5 layers, 180 parameters) as the target of
    OptimizerSPSA (10 steps on every parameter) and of OptimizerFourier
    (order 2, 3 steps on the 12 angles of the last rz column, the others
    held): the loss falls, and the ms of a target evaluation."""
    import torch
    from deepquantum_tpu_torch.optimizer import OptimizerFourier, OptimizerSPSA
    cir = bench_circuit(n)
    p0 = cir.params.double().cpu().numpy()
    calls = []

    def loss(x):
        t0 = time.perf_counter()
        with torch.no_grad():
            value = cir.expectation(params=torch.as_tensor(x, device='cuda'))[0].item()
        calls.append(time.perf_counter() - t0)
        return value

    start = loss(p0)
    spsa = OptimizerSPSA(loss, p0, random_state=SEED)
    spsa.set_hyperparam({'a': 0.5, 'c': 0.1, 'A': 10, 'nepoch': OPT_SPSA_STEPS, 'alpha': 0.602,
                         'gamma': 0.101})
    t0 = time.perf_counter()
    spsa.run(OPT_SPSA_STEPS)
    spsa_s = time.perf_counter() - t0
    spsa_calls = len(calls) - 1
    # the last layer's rz column (its rx columns commute with the X string
    # that the CNOT ring maps the observable to: their gradient is zero)
    last = list(range(len(p0) - 3 * n + 1, len(p0), 3))

    def sub_loss(x):
        full = p0.copy()
        full[last] = x
        return loss(full)

    fourier = OptimizerFourier(sub_loss, p0[last], order=2, lr=0.1)
    t0 = time.perf_counter()
    fourier.run(OPT_FOURIER_STEPS)
    fourier_s = time.perf_counter() - t0
    end_fourier = sub_loss(fourier.params)
    ms = 1e3 * float(np.median(calls))
    out = dict(start=start, spsa_best=spsa.best_target, fourier_end=end_fourier,
               evaluations=len(calls), spsa_s=spsa_s, fourier_s=fourier_s, eval_ms=ms)
    print(f'optimizers on the n={n} bench loss ({len(p0)} parameters): start {start:.8f}; SPSA '
          f'{OPT_SPSA_STEPS} steps, best {spsa.best_target:.8f} ({spsa_calls} evaluations, '
          f'{spsa_s:.2f} s); Fourier order 2, {OPT_FOURIER_STEPS} steps on {len(last)} angles, '
          f'{end_fourier:.8f} ({fourier_s:.2f} s); a target evaluation {ms:.2f} ms (median of '
          f'{len(calls)}, host clock) [{card}]')
    if not (spsa.best_target < start and end_fourier < start):
        raise AssertionError(f'9s: the loss did not fall: {out}')
    return {}, out


# ----------------------------------------------------------------- profile
# ------------------------------------------- the rest of the qubit engine
QFT_N = 24
QCNN_N, QCNN_LAYERS = 18, 3
ADJ_N = 18
COND_N = 20
MPS_N, MPS_CHI, MPS_LAYERS, MPS_SHOTS = 100, 64, 8, 10 ** 4
MPS_EXACT_N, MPS_EXACT_LAYERS, MPS_EXACT_CHI = 16, 5, 256


def _models():
    _pkg()
    from deepquantum_tpu_torch import adjoint, models, mps
    return models, adjoint, mps


def check_qft(card: str, reps: int = 10):
    """QuantumFourierTransform(24) on a basis state |x> (x from the seed):
    24 h, 276 cp and 12 swap on the planar route (K2 windows, K1 for the
    leftover groups). The state against the analytic transform
    sum_j exp(2 pi i j x / N) / sqrt(N) |j> (numpy complex128, the wire order
    tests/test_torch_ansatz.py pins against the JAX package) and against
    the port's complex128 route on the card (<= 1e-5); then QFT^-1 returns
    |x> (<= 1e-5). Launches per kernel and the forward's medians on the
    kernel and twin routes."""
    import torch
    dqt = _pkg()[0]
    models = _models()[0]
    n, dim = QFT_N, 1 << QFT_N
    x = int(np.random.default_rng(SEED + 10).integers(dim))
    label = f'QFT n={n}, |x={x}>'
    qft = models.QuantumFourierTransform(n)
    if qft.device.type != 'cuda' or not qft._planar_ok():
        raise AssertionError(f'{label}: device {qft.device}, planar {qft._planar_ok()}')
    names = [op.name for op in qft.operators]
    if (names.count('Hadamard'), names.count('PhaseShift'), names.count('Swap')) != (
            n, n * (n - 1) // 2, n // 2):
        raise AssertionError(f'{label}: gate counts {len(names)}')
    ket = torch.zeros(dim, dtype=torch.complex64, device='cuda')
    ket[x] = 1
    with torch.inference_mode():
        reset_counts()
        out = qft.forward(state=ket).reshape(-1).clone()
        torch.cuda.synchronize()
        counts = read_counts()
        back = qft.inverse().forward(state=out).reshape(-1)
        d_back = (back - ket).abs().max().item()
    if counts['window_apply'] <= 0:
        raise AssertionError(f'{label}: window_apply was not launched: {counts}')
    j = np.arange(dim, dtype=np.float64)
    want = np.exp(2j * np.pi * ((j * x) % dim) / dim) / np.sqrt(dim)
    d_exact = float(np.abs(out.cpu().numpy().astype(np.complex128) - want).max())
    del want, j
    dqt.set_dtype('complex128')
    try:
        ref_cir = models.QuantumFourierTransform(n)
        if ref_cir._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        with torch.inference_mode():
            ref = ref_cir.forward(state=ket.to(torch.complex128)).reshape(-1)
            d_ref = (out.to(torch.complex128) - ref).abs().max().item()
        del ref
    finally:
        dqt.set_dtype('complex64')
    print(f'{label}: launches {counts}; max|d| to the analytic QFT {d_exact:.2e}, to complex128 '
          f'{d_ref:.2e}; QFT^-1 QFT |x> max|d| {d_back:.2e}')
    if not (d_exact <= 1e-5 and d_ref <= 1e-5 and d_back <= 1e-5):
        raise AssertionError(f'{label}: differs from the analytic transform or complex128')
    with torch.inference_mode():
        step = (lambda: qft.forward(state=ket))
        t = _in_turns(step, reps)
    print(f'{label}: forward median over {reps} (in turns): kernel route {t["kernel"]:.3f} ms, '
          f'twin route {t["twin"]:.3f} ms [{card}]')
    return counts, dict(forward_ms=t['kernel'], twin_forward_ms=t['twin'], err_exact=d_exact,
                        err_complex128=d_ref, err_inverse=d_back)


def qcnn_circuit(device=None):
    """QuantumConvolutionalNeuralNetwork(18, nlayer=3): wires 18 -> 9 -> 5
    -> 3, the latent gate on 3 wires; Z on wire 0; parameters from numpy's
    generator seeded with SEED (the construction draws them)."""
    models = _models()[0]
    np.random.seed(SEED)
    cir = models.QuantumConvolutionalNeuralNetwork(QCNN_N, QCNN_LAYERS, device=device)
    cir.observable(0)
    return cir


def check_qcnn(card: str, reps: int = 10):
    """The QCNN training step at n=18: expectation, backward, SGD, with the
    shared parameters (42 trainable). Loss and gradient against the complex128
    route (<= 1e-5 / <= 1e-4); three SGD steps on the kernel and twin
    routes (<= 1e-5 apart); launches, medians in turns, busy share."""
    import torch
    dqt = _pkg()[0]
    label = f'QCNN n={QCNN_N}, {QCNN_LAYERS} layers'
    cir = qcnn_circuit()
    if cir.device.type != 'cuda' or not cir._planar_ok():
        raise AssertionError(f'{label}: device {cir.device}, planar {cir._planar_ok()}')
    p0 = cir.params
    p = p0.clone().requires_grad_()
    reset_counts()
    loss, grad = grad_step(cir, p, update=False)
    torch.cuda.synchronize()
    counts = read_counts()
    dqt.set_dtype('complex128')
    try:
        ref = qcnn_circuit('cuda')
        if ref._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        ref_loss, ref_grad = grad_step(ref, ref.params.requires_grad_(), update=False)
    finally:
        dqt.set_dtype('complex64')
    d_loss = abs(loss.item() - ref_loss.item())
    d_grad = (grad.double() - ref_grad).abs().max().item()
    print(f'{label}: {p0.numel()} parameters, launches per step {counts}, loss {loss.item():.8f} '
          f'(complex128 {ref_loss.item():.8f}), |d loss| {d_loss:.2e}, max|d grad| {d_grad:.2e} '
          f'(max|grad| {ref_grad.abs().max().item():.3e})')
    if not (torch.isfinite(grad).all() and d_loss <= 1e-5 and d_grad <= 1e-4):
        raise AssertionError(f'{label}: differs from the complex128 route')
    losses = {}
    for route in ('kernel', 'twin'):
        p = p0.clone().requires_grad_()
        with (twin_route() if route == 'twin' else contextlib.nullcontext()):
            losses[route] = [grad_step(cir, p)[0].item() for _ in range(3)]
    d_sgd = max(abs(a - b) for a, b in zip(losses['kernel'], losses['twin']))
    print(f'{label}: 3 SGD steps, kernel route {[round(v, 8) for v in losses["kernel"]]}, '
          f'max |d| to the twin route {d_sgd:.2e}')
    if not d_sgd <= 1e-5:
        raise AssertionError(f'{label}: the SGD losses of the kernel and twin routes differ')
    p = p0.clone().requires_grad_()
    t = _in_turns(lambda: grad_step(cir, p, update=False), reps)
    dev = _device_profile(lambda: grad_step(cir, p, update=False), 1)
    busy = dev['device_ms_per_step'] / t['kernel']
    print(f'{label}: step median over {reps} (in turns): kernel route {t["kernel"]:.3f} ms, twin '
          f'route {t["twin"]:.3f} ms; device {dev["device_ms_per_step"]:.3f} ms a step '
          f'({dev["device_ops_per_step"]:.0f} device ops, busy {busy:.1%}) [{card}]')
    return counts, dict(step_ms=t['kernel'], twin_step_ms=t['twin'], device_busy_share=busy,
                        err_loss=d_loss, err_grad=d_grad)


def check_adjoint(card: str, reps: int = 10):
    """make_adjoint_expectation at bench_suite.py::bench_gradient_adjoint's
    cell n=18, 5 layers (the bench ansatz): on the planar route it rides
    the circuit's planar chain, whose backward un-applies each window (K3 /
    K4); value and gradient against the port's complex128 einsum route
    with plain autograd (<= 1e-5 / <= 1e-4; phase 6's reference), K4
    launched once, the median step. The einsum-route Function at n=14 in
    complex128 against plain autograd (<= 1e-10), and make_layered_vqe(18,
    5) against the QubitCircuit it mirrors (<= 1e-5 / <= 1e-4)."""
    import torch
    dqt = _pkg()[0]
    models, adjoint, _ = _models()
    label = f'adjoint n={ADJ_N}, {LAYERS} layers'
    cir = bench_circuit(ADJ_N)
    fn = adjoint.make_adjoint_expectation(cir)
    p = cir.params.requires_grad_()
    reset_counts()
    e = fn(p)
    e.backward()
    torch.cuda.synchronize()
    counts = read_counts()
    g = p.grad
    ref_loss, ref_grad, _ = _reference_grad(ADJ_N, None, LAYERS, sgd_steps=3)
    d_e, d_g = abs(e.item() - ref_loss), (g.double() - ref_grad).abs().max().item()
    print(f'{label}: launches {counts}, |d value| {d_e:.2e}, max|d grad| {d_g:.2e} (max|grad| '
          f'{ref_grad.abs().max().item():.3e}) against the complex128 einsum route')
    if not (d_e <= 1e-5 and d_g <= 1e-4) or counts['window_chain_bwd'] != 1:
        raise AssertionError(f'{label}: differs from the complex128 route, or K4 not launched '
                             'once')

    def step():
        p.grad = None
        fn(p).backward()

    t, _ = time_ms(step, reps=reps, warmup=1)
    dqt.set_dtype('complex128')
    try:
        small = bench_circuit(14, 'cuda')
        sfn = adjoint.make_adjoint_expectation(small)
        ps = small.params.requires_grad_()
        es = sfn(ps)
        es.backward()
        qs = small.params.requires_grad_()
        rs = small.expectation(params=qs)[0]
        rs.backward()
        d_small = max(abs(es.item() - rs.item()), (ps.grad - qs.grad).abs().max().item())
        t_small, _ = time_ms(lambda: sfn(ps).backward(), reps=3, warmup=1)
    finally:
        dqt.set_dtype('complex64')
    print(f'adjoint einsum-route Function n=14, complex128: max|d| to autograd {d_small:.2e}, '
          f'value and gradient {t_small:.1f} ms')
    if not d_small <= 1e-10:
        raise AssertionError('the einsum-route adjoint differs from autograd')
    np.random.seed(SEED)
    lfn, lp = models.make_layered_vqe(ADJ_N, LAYERS)
    mirror = bench_circuit(ADJ_N)
    lp = lp.requires_grad_()
    le = lfn(lp)
    le.backward()
    mq = lp.detach().reshape(-1).clone().requires_grad_()
    me = mirror.expectation(params=mq)[0]
    me.backward()
    d_l = abs(le.item() - me.item())
    d_lg = (lp.grad.reshape(-1) - mq.grad).abs().max().item()
    print(f'make_layered_vqe({ADJ_N}, {LAYERS}): |d value| {d_l:.2e}, max|d grad| {d_lg:.2e} '
          f'against the bench circuit; adjoint step median over {reps}: {t:.3f} ms [{card}]')
    if not (d_l <= 1e-5 and d_lg <= 1e-4):
        raise AssertionError('make_layered_vqe differs from the circuit it mirrors')
    return counts, dict(step_ms=t, einsum_n14_ms=t_small, err_einsum=d_small)


def conditional_circuit(device=None):
    """n=20: h on wires 0-9, x(10 + i) conditioned on wire i, then the bench
    layers (rx, rz, rx, CNOT ring) on wires 10-19."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(COND_N, device=device)
    half = COND_N // 2
    for i in range(half):
        cir.h(i)
    for i in range(half):
        cir.x(half + i, controls=i, condition=True)
    for _ in range(LAYERS):
        for w in range(half, COND_N):
            cir.rx(w)
            cir.rz(w)
            cir.rx(w)
        cir.cnot_ring(minmax=[half, COND_N - 1])
    cir.init_para(SEED)
    return cir


def check_conditional(card: str):
    """The conditional circuit at n=20 on the einsum route: the state
    against complex128 (<= 1e-5); defer_measure(with_prob=True) from a
    seeded card generator gives a state of norm 1 (<= 1e-5) whose
    probability is get_prob(bits, wires_condition)'s (<= 1e-5 of it), and
    post_select(bits) the same state (<= 1e-6); the time of each call."""
    import torch
    dqt = _pkg()[0]
    label = f'conditional n={COND_N}'
    cir = conditional_circuit()
    half = COND_N // 2
    if cir.device.type != 'cuda' or cir._planar_ok() or cir.wires_condition != list(range(half)):
        raise AssertionError(f'{label}: device {cir.device}, planar {cir._planar_ok()}, '
                             f'condition wires {cir.wires_condition}')
    with torch.inference_mode():
        reset_counts()
        state, fwd_ms = _one_call_ms(cir.forward)
        counts = read_counts()
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        (sliced, bits, prob), defer_ms = _one_call_ms(
            lambda: cir.defer_measure(with_prob=True, generator=gen))
        pr, prob_ms = _one_call_ms(lambda: cir.get_prob(bits, wires=cir.wires_condition))
        post, post_ms = _one_call_ms(lambda: cir.post_select(bits))
        norm = torch.linalg.vector_norm(sliced).item()
        d_post = (post - sliced).abs().max().item()
    dqt.set_dtype('complex128')
    try:
        with torch.inference_mode():
            d_ref = (state.to(torch.complex128)
                     - conditional_circuit('cuda').forward()).abs().max().item()
    finally:
        dqt.set_dtype('complex64')
    d_prob = abs(prob - pr.item()) / pr.item()
    print(f'{label}: bits {bits}, p {prob:.6e} (get_prob {pr.item():.6e}, rel {d_prob:.1e}), '
          f'|state| {norm:.8f}, post_select max|d| {d_post:.1e}, state to complex128 '
          f'{d_ref:.2e}; launches {counts}; forward {fwd_ms:.2f} ms, defer_measure '
          f'{defer_ms:.2f} ms, get_prob {prob_ms:.2f} ms, post_select {post_ms:.2f} ms [{card}]')
    if tuple(sliced.shape) != (1 << (COND_N - half), 1) or not (
            abs(norm - 1) <= 1e-5 and d_prob <= 1e-5 and d_post <= 1e-6 and d_ref <= 1e-5):
        raise AssertionError(f'{label}: a bar missed')
    return counts, dict(forward_ms=fwd_ms, defer_measure_ms=defer_ms, get_prob_ms=prob_ms,
                        post_select_ms=post_ms)


def mps_circuit(n: int, chi: int, layers: int, device=None, mps: bool = True):
    """layers x (rx, rz, rx on every wire; cnot(i, i + 1) chain), Z on wire
    0, parameters from init_para(SEED); an MPS with bond chi, or with
    ``mps=False`` the same circuit on a state vector."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(n, device=device, mps=mps, chi=chi if mps else None)
    for _ in range(layers):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        for i in range(n - 1):
            cir.cnot(i, i + 1)
    cir.observable(0)
    cir.init_para(SEED)
    return cir


@contextlib.contextmanager
def count_factorisations(counts: dict):
    """Count the torch.linalg.svd and torch.linalg.qr calls made inside."""
    import torch
    saved = torch.linalg.svd, torch.linalg.qr

    def wrap(fn, key):
        def counted(*args, **kwargs):
            counts[key] = counts.get(key, 0) + 1
            return fn(*args, **kwargs)
        return counted

    torch.linalg.svd, torch.linalg.qr = wrap(saved[0], 'svd'), wrap(saved[1], 'qr')
    try:
        yield counts
    finally:
        torch.linalg.svd, torch.linalg.qr = saved


def _cuda_only_device_ms(step) -> float:
    """Device time of one call of ``step`` from a profiler window that
    records the card's activity only: a window that also records every
    host op cost ~2 ms an op over a whole Hessian call, and an MPS step
    issues tens of thousands of small ones."""
    import torch
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, 'self_device_time_total', None)
            total += float(t if t is not None else getattr(ev, 'self_cuda_time_total', 0.0))
    return total / 1e3


def _mps_step(cir):
    """Forward, <Z0> and its gradient on the MPS: (value, gradient)."""
    p = cir.params.requires_grad_()
    e = cir.expectation(params=p)[0]
    e.backward()
    return e.detach(), p.grad


def _mps_last_layer():
    """The MPS circuit's last layer (rx, rz, rx on every wire; the CNOT
    chain; Z on wire 0) on the MPS the first MPS_LAYERS - 1 layers make: a
    window of the step at full bond."""
    import torch
    dqt = _pkg()[0]
    mps = _models()[2]
    with torch.inference_mode():
        tensors = mps_circuit(MPS_N, MPS_CHI, MPS_LAYERS - 1).forward()
    init = mps.MatrixProductState(MPS_N, [t.clone() for t in tensors], chi=MPS_CHI)
    cir = dqt.QubitCircuit(MPS_N, init_state=init, mps=True, chi=MPS_CHI)
    for i in range(MPS_N):
        cir.rx(i)
        cir.rz(i)
        cir.rx(i)
    for i in range(MPS_N - 1):
        cir.cnot(i, i + 1)
    cir.observable(0)
    cir.init_para(SEED)
    return cir


def check_mps(card: str):
    """MPS at 100 qubits, chi=64, 8 layers (the bond would reach 256, so
    truncation runs): <Z0> and its gradient at complex64 against the same
    MPS at complex128 on the card (<= 1e-4; <= 1e-3 of max|g|), the norm
    (<= 1e-4), 10^4 shots of wire 0 within 5 sigma of (1 - <Z0>) / 2; the
    100-qubit GHZ state giving only its two strings (a chi-square); exact at
    n=16, 5 layers, chi=256 against the kernel state-vector route (state up
    to a global phase <= 1e-5, <Z0> <= 1e-5, gradient <= 1e-4). Forward and
    gradient times, SVD / QR calls of a step, and the busy share of the last
    layer's value and gradient at full bond (``_mps_last_layer``)."""
    import torch
    dqt = _pkg()[0]
    mps = _models()[2]
    label = f'MPS n={MPS_N}, chi={MPS_CHI}, {MPS_LAYERS} layers'
    parts, t0 = {}, time.perf_counter()

    def part(name):
        nonlocal t0
        parts[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    cir = mps_circuit(MPS_N, MPS_CHI, MPS_LAYERS)
    if cir.device.type != 'cuda':
        raise AssertionError(f'{label}: the circuit landed on {cir.device}')
    with torch.inference_mode(), count_factorisations({}) as fwd_calls:
        tensors, fwd_ms = _one_call_ms(cir.forward)
    bond = max(t.shape[-1] for t in tensors)
    norm = mps.inner_product_mps(tensors, tensors).real.item()
    part('forward')
    with count_factorisations({}) as step_calls:
        (e, g), step_ms = _one_call_ms(lambda: _mps_step(cir))
    part('step')
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    with torch.inference_mode():
        shots, shots_ms = _one_call_ms(lambda: cir.measure(shots=MPS_SHOTS, wires=[0],
                                                          generator=gen))
    part('shots')
    layer = _mps_last_layer()
    _, layer_ms = _one_call_ms(lambda: _mps_step(layer))
    dev_ms = _cuda_only_device_ms(lambda: _mps_step(layer))
    busy = dev_ms / layer_ms
    part('last layer, profiled')
    p1 = (1 - e.item()) / 2
    f1 = shots.get('1', 0) / MPS_SHOTS
    z = abs(f1 - p1) / np.sqrt(max(p1 * (1 - p1), 1e-12) / MPS_SHOTS)
    dqt.set_dtype('complex128')
    try:
        ref = mps_circuit(MPS_N, MPS_CHI, MPS_LAYERS, 'cuda')
        (e_ref, g_ref), ref_ms = _one_call_ms(lambda: _mps_step(ref))
    finally:
        dqt.set_dtype('complex64')
    part('complex128 step')
    d_e = abs(e.item() - e_ref.item())
    d_g = (g.double() - g_ref).abs().max().item() / g_ref.abs().max().item()
    print(f'{label}: max bond {bond}, norm {norm:.8f}, <Z0> {e.item():.8f} (complex128 '
          f'{e_ref.item():.8f}), |d| {d_e:.2e}, gradient max|d| / max|g| {d_g:.2e}; wire 0 in '
          f'{MPS_SHOTS} shots: {f1:.4f} against {p1:.4f} ({z:.2f} sigma, {shots_ms:.1f} ms); '
          f'forward {fwd_ms:.1f} ms ({fwd_calls}), value and gradient {step_ms:.1f} ms '
          f'({step_calls}; complex128 {ref_ms:.1f} ms); the last layer\'s value and gradient '
          f'{layer_ms:.1f} ms, device {dev_ms:.1f} ms, busy {busy:.1%} [{card}]')
    if not (bond == MPS_CHI and abs(norm - 1) <= 1e-4 and d_e <= 1e-4 and d_g <= 1e-3
            and z <= 5 and torch.isfinite(g).all()):
        raise AssertionError(f'{label}: a bar missed')

    ghz = dqt.QubitCircuit(MPS_N, mps=True, chi=16)
    ghz.h(0)
    for i in range(MPS_N - 1):
        ghz.cnot(i, i + 1)
    with torch.inference_mode():
        ghz()
        res = ghz.measure(shots=MPS_SHOTS, generator=gen)
    stat = sum((c - MPS_SHOTS / 2) ** 2 / (MPS_SHOTS / 2) for c in res.values())
    part('ghz')
    print(f'MPS GHZ n={MPS_N}: {len(res)} strings, chi-square {stat:.2f} on 1 dof')
    if set(res) != {'0' * MPS_N, '1' * MPS_N} or not stat <= 1 + 6 * np.sqrt(2):
        raise AssertionError(f'MPS GHZ: outcomes {list(res)[:3]}, chi-square {stat}')

    n = MPS_EXACT_N
    exact = mps_circuit(n, MPS_EXACT_CHI, MPS_EXACT_LAYERS)
    sv = mps_circuit(n, MPS_EXACT_CHI, MPS_EXACT_LAYERS, mps=False)
    if not sv._planar_ok():
        raise AssertionError('the state-vector reference must take the planar route')
    with torch.inference_mode():
        psi_mps = mps.full_tensor(exact.forward())
        psi = sv.forward().reshape(-1)
    k = int(psi.abs().argmax())
    d_psi = (psi_mps * (psi[k] / psi_mps[k]) - psi).abs().max().item()
    (e_m, g_m), (e_s, g_s) = _mps_step(exact), _mps_step(sv)
    d_ez, d_gz = abs(e_m.item() - e_s.item()), (g_m - g_s).abs().max().item()
    part(f'exact n={n}')
    print(f'MPS n={n}, chi={MPS_EXACT_CHI}, {MPS_EXACT_LAYERS} layers against the kernel state '
          f'vector: state {d_psi:.2e}, <Z0> {d_ez:.2e}, gradient {d_gz:.2e}; wall seconds of '
          f'the MPS phase\'s parts {parts}')
    if not (d_psi <= 1e-5 and d_ez <= 1e-5 and d_gz <= 1e-4):
        raise AssertionError(f'MPS n={n}: differs from the state-vector route')
    return dict(forward_ms=fwd_ms, step_ms=step_ms, complex128_step_ms=ref_ms,
                step_factorisations=step_calls, forward_factorisations=fwd_calls,
                last_layer_step_ms=layer_ms, last_layer_device_ms=dev_ms,
                device_busy_share=busy, shots_ms=shots_ms, seconds=parts)


PARTS = {   # label -> where the real step spends host time
    'sequence': 'QubitCircuit._planar_seq (gate matrices, window plan and products)',
    'sequence_batched': 'QubitCircuit._planar_seq_batched (every group\'s (B, K, K) matrices)',
    'chain_forward': 'planar_chain (K3 at n=18; one planar_chain_batched launch in the QML '
                     'step)',
    'pauli_expectation': 'planar_pauli_expectation (K3 at n=18; one planar_chain_batched launch '
                         'in the QML step)',
    'chain_backward': '_chain_backward, the adjoint walk inside loss.backward() (K4 at n=18; '
                      'one planar_chain_batched_bwd launch in the QML step)',
}


@contextlib.contextmanager
def labelled_parts(host_ms: dict):
    """Run the real entry points with the functions of PARTS wrapped: each
    adds its host time (no synchronise) to ``host_ms`` and shows as a
    ``dq:<label>`` range in a torch.profiler trace."""
    import torch
    dqt, pg, _, _ = _pkg()

    def wrap(label, fn):
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(f'dq:{label}'):
                out = fn(*args, **kwargs)
            host_ms[label] = host_ms.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return inner

    patches = [(dqt.QubitCircuit, '_planar_seq', 'sequence'),
               (dqt.QubitCircuit, '_planar_seq_batched', 'sequence_batched'),
               (pg, 'planar_chain', 'chain_forward'),
               (pg, 'planar_pauli_expectation', 'pauli_expectation'),
               (pg, '_chain_backward', 'chain_backward')]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, label in patches:
        setattr(mod, name, wrap(label, getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _synced(fn):
    """(fn(), host ms until the device has finished it)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_training(card: str, n: int = 18, reps: int = 10, steps: int = 5) -> dict:
    """Where one grad step (phase 6's ``grad_step`` on ``bench_circuit``)
    spends its time: the free-running median; the host time of each of
    PARTS inside the free-running step; a split of the real calls with a
    synchronise after expectation, backward and update (the parts then
    serialise host and device); and one torch.profiler window of ``steps``
    steps for the device time, the device operations and the top kernels."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    cir = bench_circuit(n)
    p = cir.params.requires_grad_()
    t_step, all_steps = time_ms(lambda: grad_step(cir, p), reps=reps, warmup=3)

    host_ms: dict = {}
    with labelled_parts(host_ms):
        t0 = time.perf_counter()
        for _ in range(reps):
            grad_step(cir, p)
        torch.cuda.synchronize()
        t_labelled = (time.perf_counter() - t0) * 1e3 / reps
    host_ms = {k: v / reps for k, v in host_ms.items()}

    def update():
        with torch.no_grad():
            p.sub_(LR * p.grad)
        p.grad = None

    split = []
    torch.cuda.synchronize()
    for _ in range(reps):
        loss, t_fwd = _synced(lambda: cir.expectation(params=p)[0])
        _, t_bwd = _synced(loss.backward)
        _, t_upd = _synced(update)
        split.append((t_fwd, t_bwd, t_upd))
    t_fwd, t_bwd, t_upd = (float(v) for v in np.median(np.array(split), axis=0))

    with labelled_parts({}):
        dev = _device_profile(lambda: grad_step(cir, p), steps)
    return dict(
        card=card, device=torch.cuda.get_device_name(0), n=n, layers=LAYERS, parts=PARTS,
        step_ms_median=t_step, step_ms_all=all_steps, step_ms_with_labels=t_labelled,
        host_ms_per_step=host_ms,
        sync_split_ms=dict(forward_and_expectation=t_fwd, backward=t_bwd, update=t_upd,
                           total=t_fwd + t_bwd + t_upd),
        profiled_steps=steps, device_busy_share=dev['device_ms_per_step'] / t_step, **dev)


def profile_batched_qml(card: str, reps: int = 10, steps: int = 3) -> dict:
    """Where one batched QML step (``qml_step`` on ``qml_circuit``, plain
    variant, B=100) spends its time, as ``profile_training`` splits the VQE
    step: the free-running median, the host time of PARTS inside it, a
    synchronised split, and the profiler's device time and top kernels."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    cir = qml_circuit()
    leaves = _qml_leaves(cir, cir.device, False)
    t_step, all_steps = time_ms(lambda: qml_step(cir, leaves, False), reps=reps, warmup=3)
    host_ms: dict = {}
    with labelled_parts(host_ms):
        for _ in range(reps):
            qml_step(cir, leaves, False)
        torch.cuda.synchronize()
    host_ms = {k: v / reps for k, v in host_ms.items()}
    p, data = leaves[0], leaves[1]

    def update():
        with torch.no_grad():
            p.sub_(LR * p.grad)
        p.grad = None

    split = []
    for _ in range(reps):
        loss, t_fwd = _synced(lambda: cir.expectation(data=data, params=p).mean())
        _, t_bwd = _synced(loss.backward)
        _, t_upd = _synced(update)
        split.append((t_fwd, t_bwd, t_upd))
    t_fwd, t_bwd, t_upd = (float(v) for v in np.median(np.array(split), axis=0))
    with labelled_parts({}):
        dev = _device_profile(lambda: qml_step(cir, leaves, False), steps)
    return dict(
        card=card, device=torch.cuda.get_device_name(0), n=QML_N, layers=QML_LAYERS, batch=QML_B,
        parts=PARTS, step_ms_median=t_step, step_ms_all=all_steps, host_ms_per_step=host_ms,
        sync_split_ms=dict(forward_and_expectation=t_fwd, backward=t_bwd, update=t_upd,
                           total=t_fwd + t_bwd + t_upd),
        profiled_steps=steps, device_busy_share=dev['device_ms_per_step'] / t_step, **dev)


def _device_profile(step, steps: int) -> dict:
    """One torch.profiler window of ``steps`` calls of ``step``: device time,
    device operations, CPU time in cudaLaunchKernel, the host time of the
    ``dq:`` ranges and the top kernels, per call."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    dev_us, dev_ops, by_name, launch_us, ranges = 0.0, 0, [], 0.0, {}
    for ev in prof.key_averages():
        if ev.key.startswith('dq:'):
            # a range shows twice: on the host, and as an annotation on the
            # device side that spans its kernels and is no device work itself
            if ev.device_type == torch.autograd.DeviceType.CPU:
                ranges[ev.key[3:]] = ev.cpu_time_total / 1e3 / steps
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            # the attribute was renamed across PyTorch versions
            t = getattr(ev, 'self_device_time_total', None)
            t = float(t if t is not None else getattr(ev, 'self_cuda_time_total', 0.0))
            dev_us += t
            dev_ops += ev.count
            by_name.append((t, ev.count, ev.key))
        elif ev.key == 'cudaLaunchKernel':
            launch_us = ev.self_cpu_time_total
    by_name.sort(reverse=True)

    def row(t, c, k):
        return dict(name=k[:90], ms_per_step=t / 1e3 / steps, calls_per_step=c / steps)

    return dict(
        profiled_range_host_ms_per_step=ranges,
        device_ms_per_step=dev_us / 1e3 / steps, device_ops_per_step=dev_ops / steps,
        cuda_launch_cpu_ms_per_step=launch_us / 1e3 / steps,
        top_kernels=[row(*r) for r in by_name[:12]],
        # the port's own kernels (csrc/), all of them
        port_kernels=[row(*r) for r in by_name if re.search(PORT_KERNEL, r[2])])


def profile_photonic(card: str) -> dict:
    """Where one call of each photonic path spends its time, at complex128:
    the free-running median, a split with a synchronise after each part
    (medians of 3), and one torch.profiler window for the device time."""
    import torch
    dqt = _pkg()[0]
    from deepquantum_tpu_torch.photonic import gaussian_prob
    rng = np.random.default_rng(SEED + 2)

    def split(parts):
        rows = [[_synced(fn)[1] for _, fn in parts] for _ in range(3)]
        return {name: float(v) for (name, _), v in zip(parts, np.median(np.array(rows), axis=0))}

    out = dict(card=card, device=torch.cuda.get_device_name(0))
    with complex128(), torch.no_grad():
        cir = dqt.photonic.Clements(BS_MODES, [1] * BS_PHOTONS + [0] * (BS_MODES - BS_PHOTONS),
                                    cutoff=BS_PHOTONS + 1)
        angles = rng.uniform(0, 2 * np.pi, cir.ndata)
        in_state = cir._basis_input(None)
        basis = cir._output_basis(in_state)
        full = cir._full_params(None, angles, cir._data_indices(len(angles)))
        amps = cir._fock_basis_amps(angles, in_state, basis)
        t_a, _ = time_ms(lambda: cir(data=angles, is_prob=True), reps=5, warmup=1)
        out['boson_sampling'] = dict(
            modes=BS_MODES, photons=BS_PHOTONS, outcomes=len(basis), call_ms_median=t_a,
            sync_split_ms=split([
                ('unitary (gate matrices and their product)', lambda: cir._unitary_of(full)),
                ('amplitudes (unitary, sub-matrix gather, K7, norms)',
                 lambda: cir._fock_basis_amps(angles, in_state, basis)),
                ('dict of FockState keys, sorted',
                 lambda: cir._state_dict(basis, amps.abs() ** 2, True))]),
            **_device_profile(lambda: cir(data=angles, is_prob=True), 3))

        gbs_out = {}
        for nmode in (GBS_MODES, GBS_BIG):
            gbs = _gbs_circuit(nmode, False, rng)
            cov, mean = gbs()
            t_b, _ = time_ms(lambda: gbs(is_prob=True), reps=3, warmup=1)

            def table():
                return gaussian_prob.fock_probs_gaussian(cov, mean, gbs.cutoff, 'threshold')

            row = dict(
                modes=nmode, patterns=1 << nmode, call_ms_median=t_b,
                sync_split_ms=split([
                    ('Gaussian state (symplectic folds over the gates)', lambda: gbs()),
                    ('Q-function matrices', lambda: gaussian_prob._q_mats(cov[0], mean[0])),
                    ('all patterns (Q matrices, then a batched torontonian per click count)',
                     table)]),
                table_split_ms=_table_split(table),
                **_device_profile(lambda: gbs(is_prob=True), 1))
            row['device_busy_share'] = row['device_ms_per_step'] / t_b
            gbs_out[f'{nmode}_modes'] = row
        out['gaussian_boson_sampling'] = gbs_out
    out['boson_sampling']['device_busy_share'] = (out['boson_sampling']['device_ms_per_step']
                                                  / out['boson_sampling']['call_ms_median'])
    return out


def _table_split(table, reps: int = 3) -> dict:
    """The threshold table's parts, each between two synchronisations (so
    host and device serialise), medians over ``reps`` calls: grouping the
    patterns (host), the groups' gathers, the K8 wrapper calls (their
    launches), the plain formula below 3 clicks, the epilogues, and the rest
    (Q matrices, the scatter back)."""
    import torch
    from deepquantum_tpu_torch.photonic import gaussian_prob as gp
    _, _, _, pt = _photonic()
    labels = [(gp, 'click_groups', 'grouping by click count (host)'),
              (gp, 'gather_group', 'gathers, one per click count'),
              (pt, 'tor_dets_cuda', 'K8 wrapper calls, one per click count >= 3'),
              (pt, '_torontonian_plain', 'plain formula, click counts <= 2'),
              (pt, '_tor_epilogue', 'epilogues, one per click count >= 3')]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in labels]
    runs = []

    def timed(label, fn, ms):
        def inner(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms[label] = ms.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return inner

    try:
        for _ in range(reps):
            ms: dict = {}
            for mod, name, label in labels:
                setattr(mod, name, timed(label, getattr(mod, name), ms))
            _, total = _synced(table)
            for mod, name, fn in saved:
                setattr(mod, name, fn)
            ms['rest (Q matrices, scatter back)'] = total - sum(ms.values())
            ms['total'] = total
            runs.append(ms)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return {k: float(np.median([r.get(k, 0.0) for r in runs])) for k in runs[0]}



# ------------------------------------------------- distributed circuits (9t-9v)
SHARD_N, SHARD_K = 28, 4          # 9t: n=28 on 4 shards of the card
GSPMD_N, GSPMD_K = 24, 2          # 9u
GSPMD_SHOTS = 100_000
GSPMD_WIRES = [0, 1, 2, 3]
FOCK_K = 2                        # 9v: 9l's CV-QNN on 2 shards
STATE_BAR, VALUE_BAR, GRAD_BAR = 1e-5, 1e-5, 1e-4
WS1_BAR = 1e-6
C128_BAR, ADJ_BAR = 1e-10, 1e-8


def card_mesh(k: int):
    """k shards on the one card."""
    _pkg()
    from deepquantum_tpu_torch.parallel import make_mesh
    return make_mesh(devices=['cuda:0'] * k)


def _rel(got, ref) -> float:
    return ((got.to(ref.dtype) - ref).abs().max() / ref.abs().max()).item()


@contextlib.contextmanager
def exchange_events(record: list):
    """CUDA events around every half-shard swap and 'g1' blend of the
    shardmap engine, and around every forward and backward step, into
    ``record`` as (kind, start, end); read after a synchronise."""
    import torch
    _pkg()
    from deepquantum_tpu_torch.ops import planar_gate as pg
    from deepquantum_tpu_torch.parallel import shardmap_engine as se

    def timed(kind_of, fn):
        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            record.append((kind_of(args), start, end))
            return out
        return wrapped

    saved = {name: getattr(se, name) for name in ('_swap_gl', '_g1_apply', '_step_apply',
                                                  '_step_bwd')}
    se._swap_gl = timed(lambda a: 'exchange', saved['_swap_gl'])
    se._g1_apply = timed(lambda a: 'exchange', saved['_g1_apply'])
    se._step_apply = timed(lambda a: 'step:' + a[4][0], saved['_step_apply'])
    se._step_bwd = timed(lambda a: 'step:' + a[5][0], saved['_step_bwd'])
    rotate = pg._rotate_planar
    pg._rotate_planar = timed(lambda a: 'relabel', rotate)
    try:
        yield record
    finally:
        for name, fn in saved.items():
            setattr(se, name, fn)
        pg._rotate_planar = rotate


def _event_split(record: list) -> dict:
    """ms per kind: 'exchange' (swaps and blends), 'relabel' (the local
    runs' relabel transposes), and the steps by kind ('run', 'g1', 'remap';
    a run's time includes its relabels, a remap's and a g1's its
    exchanges)."""
    out: dict = {}
    for kind, start, end in record:
        out[kind] = out.get(kind, 0.0) + start.elapsed_time(end)
    return {k: round(v, 3) for k, v in sorted(out.items())}


def dist_bench(n: int, mesh, layers: int = LAYERS, engine: str = 'auto'):
    """The bench ansatz as a DistributedQubitCircuit on ``mesh``, with
    bench_circuit's parameters."""
    dqt = _pkg()[0]
    cir = dqt.DistributedQubitCircuit(n, mesh=mesh, engine=engine)
    for _ in range(layers):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
    cir.observable(list(range(n)), basis='x' * n)
    cir.init_para(SEED)
    return cir


def check_shardmap(card: str, n: int = SHARD_N, k: int = SHARD_K):
    """Phase 9t, the shardmap engine at full width."""
    import torch
    dqt = _pkg()[0]
    cir = dist_bench(n, card_mesh(k))
    sim = cir._smap
    if cir.engine != 'shardmap' or not sim.use_kernels or sim.nlocal != n - 2:
        raise AssertionError(f'9t: engine {cir.engine}, kernels {sim.use_kernels}')
    from deepquantum_tpu_torch.parallel.sharded import full_params
    program = sim._build_program(sim._gate_list(cir, full_params(cir)))[0]
    steps = {kind: sum(st[0] == kind for st in program) for kind in ('run', 'g1', 'remap')}
    entries = [w[0] if w[0] in ('rot', 'win') else 'gate' for st in program if st[0] == 'run'
               for w in st[1]]
    steps.update({f'run:{kind}': entries.count(kind) for kind in ('gate', 'win', 'rot')})
    swaps = sum(len(st[1]) for st in program if st[0] == 'remap')
    p0 = cir.params
    with torch.no_grad():
        state = cir.forward().clone()
    fwd_ms, _ = time_ms(lambda: cir.forward(), reps=3, warmup=0)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    events: list = []
    with exchange_events(events):
        (loss, grad), ms_first = _one_call_ms(
            lambda: grad_step(cir, p0.clone().requires_grad_(), False))
        torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = _event_split(events)
    value = loss.item()
    step_ms, _ = time_ms(lambda: grad_step(cir, p0.clone().requires_grad_(), False), reps=3,
                         warmup=0)
    device_ms = _cuda_only_device_ms(lambda: grad_step(cir, p0.clone().requires_grad_(), False))
    cir.fused_bwd = False
    reset_counts()
    _, grad5 = grad_step(cir, p0.clone().requires_grad_(), update=False)
    torch.cuda.synchronize()
    counts5 = read_counts()
    cir.fused_bwd = True
    reset_counts()
    q = p0.clone().requires_grad_()
    (adj_value, adj_grad), adj_ms = _one_call_ms(
        lambda: _value_grad(lambda: cir.expectation(params=q, adjoint=True)[0], q))
    counts_adj = read_counts()
    out = dict(n=n, shards=k, steps=steps, swaps=swaps, forward_ms=fwd_ms, step_ms=step_ms,
               first_step_ms=ms_first, busy=round(device_ms / step_ms, 4), peak_gib=round(peak, 3),
               launches={kk: v for kk, v in counts.items() if v},
               launches_unfused={kk: v for kk, v in counts5.items() if v},
               launches_adjoint={kk: v for kk, v in counts_adj.items() if v}, adjoint_ms=adj_ms,
               events_ms=split, exchange_ms=split.get('exchange', 0.0), value=value)
    del cir, sim
    torch.cuda.empty_cache()
    local = bench_circuit(n)
    with torch.no_grad():
        ref_state = local.forward()[:, 0].clone()
    ref_loss, ref_grad = grad_step(local, local.params.requires_grad_(), update=False)
    ref_value = ref_loss.item()
    del local
    torch.cuda.empty_cache()
    out['state_err'] = _rel(state, ref_state)
    out['value_err'] = abs(value - ref_value)
    out['grad_err'] = _rel(grad, ref_grad)
    out['unfused_grad_err'] = _rel(grad5, grad)
    out['adjoint_value_err'] = abs(adj_value - ref_value)
    out['adjoint_grad_err'] = _rel(adj_grad, ref_grad)
    del state
    one = dist_bench(n, card_mesh(1))
    with torch.no_grad():
        out['world_size_1_err'] = _rel(one.forward(), ref_state)
    del one, ref_state
    torch.cuda.empty_cache()
    print(f"shardmap n={n} on {k} shards of the card: steps {steps} ({swaps} swaps), <X..X> "
          f"{value:.8f} (local {ref_value:.8f}); forward {fwd_ms:.1f} ms, grad step {step_ms:.1f} "
          f"ms (first {ms_first:.1f}), busy {100 * out['busy']:.1f} %, peak {out['peak_gib']} GiB; "
          f"launches a step {out['launches']}, with fused_bwd off {out['launches_unfused']}, "
          f"through expectation(adjoint=True) {out['launches_adjoint']} ({adj_ms:.1f} ms); "
          f"device ms by kind (CUDA events) {split}; off the local engine: state "
          f"{out['state_err']:.1e}, value {out['value_err']:.1e}, "
          f"gradient {out['grad_err']:.1e}, unfused gradient {out['unfused_grad_err']:.1e}, "
          f"adjoint value {out['adjoint_value_err']:.1e} and gradient "
          f"{out['adjoint_grad_err']:.1e}; the world-size-1 mesh's state "
          f"{out['world_size_1_err']:.1e} [{card}]")
    if not (out['state_err'] <= STATE_BAR and out['value_err'] <= VALUE_BAR
            and out['grad_err'] <= GRAD_BAR and out['unfused_grad_err'] <= PLANE_BAR
            and out['adjoint_value_err'] <= VALUE_BAR and out['adjoint_grad_err'] <= GRAD_BAR
            and out['world_size_1_err'] <= WS1_BAR):
        raise AssertionError(f'9t: {out}')
    for name in ('planar_apply', 'window_apply', 'planar_bwd_fused'):
        if counts[name] <= 0:
            raise AssertionError(f'9t: {name} was not launched: {counts}')
    if counts5['planar_grad'] <= 0 or counts5['planar_bwd_fused'] != 0:
        raise AssertionError(f'9t with fused_bwd off: {counts5}')
    if counts_adj['planar_apply'] <= 0 or counts_adj['planar_bwd_fused'] <= 0:
        raise AssertionError(f'9t through expectation(adjoint=True): {counts_adj}')
    merged = {kk: counts[kk] + counts5[kk] + counts_adj[kk] for kk in counts}
    return merged, out


def check_gspmd(card: str, n: int = GSPMD_N, k: int = GSPMD_K):
    """Phase 9u, the 'gspmd' engine at complex128."""
    import torch
    out = {}
    with complex128():
        mesh = card_mesh(k)
        cir = dist_bench(n, mesh)
        if cir.engine != 'gspmd':
            raise AssertionError(f'9u: engine {cir.engine}')
        reset_counts()
        with torch.no_grad():
            state, fwd_ms = _one_call_ms(lambda: cir.forward().clone())
            value = cir.expectation()[0].item()
            local = bench_circuit(n, 'cuda')
            ref_state = local.forward()[:, 0]
            ref_value = local.expectation()[0].item()
        out.update(forward_ms=fwd_ms, state_err=(state - ref_state).abs().max().item(),
                   value_err=abs(value - ref_value))
        probs = (ref_state.abs() ** 2).reshape([2] * n)
        marg = probs.sum(tuple(range(len(GSPMD_WIRES), n))).reshape(-1).double().cpu().numpy()
        del state, ref_state, probs, local
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        counts, measure_ms = _one_call_ms(lambda: cir.measure(GSPMD_SHOTS, wires=GSPMD_WIRES,
                                                              generator=gen))
        stat, dof, bar = _chi2(counts, marg, GSPMD_SHOTS)
        out.update(measure_ms=measure_ms, chi2=stat, dof=dof)
        del cir
        torch.cuda.empty_cache()
        one = dist_bench(n, mesh, layers=1)
        p = one.params
        adj, adj_ms = _one_call_ms(lambda: one.expectation(adjoint=True)[0].item())
        q = p.clone().requires_grad_()
        (val_adj, g_adj), adj_grad_ms = _one_call_ms(
            lambda: _value_grad(lambda: one.expectation(params=q, adjoint=True)[0], q))
        q2 = p.clone().requires_grad_()
        torch.cuda.reset_peak_memory_stats()
        (val_ad, g_ad), ad_ms = _one_call_ms(lambda: _value_grad(
            lambda: one.expectation(params=q2)[0], q2))
        out.update(adjoint_ms=adj_ms, adjoint_grad_ms=adj_grad_ms, autograd_ms=ad_ms,
                   autograd_peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
                   adjoint_value_err=abs(adj - val_ad), adjoint_grad_err=(g_adj - g_ad).abs().max()
                   .item(), launches=sum(read_counts().values()))
        del one
        torch.cuda.empty_cache()
    print(f"gspmd n={n} on {k} shards, complex128: forward {fwd_ms:.1f} ms, state off the local "
          f"circuit {out['state_err']:.1e}, value {out['value_err']:.1e}; measure({GSPMD_SHOTS}, "
          f"wires={GSPMD_WIRES}) {measure_ms:.1f} ms, chi-square {stat:.1f} on {dof} dof (bound "
          f"{bar:.1f}); 1 layer: expectation(adjoint=True) {adj_ms:.1f} ms, with its gradient "
          f"{adj_grad_ms:.1f} ms, autograd {ad_ms:.1f} ms (peak {out['autograd_peak_gib']} GiB); "
          f"adjoint off autograd: value {out['adjoint_value_err']:.1e}, gradient "
          f"{out['adjoint_grad_err']:.1e} [{card}]")
    if not (out['state_err'] <= C128_BAR and out['value_err'] <= C128_BAR
            and out['adjoint_value_err'] <= ADJ_BAR and out['adjoint_grad_err'] <= ADJ_BAR):
        raise AssertionError(f'9u: {out}')
    _hold_chi2('9u measure', stat, dof, bar)
    if out['launches']:
        raise AssertionError(f"9u: the complex128 engine launched {out['launches']} kernels")
    return {}, out


def _value_grad(fn, p):
    value = fn()
    value.backward()
    return value.item(), p.grad


def check_sharded_fock(card: str, k: int = FOCK_K):
    """Phase 9v, the sharded Fock tensor."""
    import torch
    dqt = _pkg()[0]

    def build(**kwargs):
        cir = dqt.DistributedQumodeCircuit(QNN_MODES, 'vac', cutoff=QNN_CUTOFF, mesh=card_mesh(k),
                                           **kwargs)
        rng = np.random.default_rng(SEED)
        for _ in range(QNN_LAYERS):
            cvqnn_layer(cir, QNN_MODES, rng)
        return cir

    cir = build()
    local = cvqnn_circuit(QNN_MODES, QNN_CUTOFF, QNN_LAYERS, SEED)
    out = {}
    with torch.no_grad():
        ref = local().reshape(-1)
        torch.cuda.reset_peak_memory_stats()
        state, first_ms = _one_call_ms(lambda: cir().clone())
        out['peak_gib'] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
        fwd_ms, _ = time_ms(lambda: cir(), reps=3, warmup=0)
        out.update(ops=len(cir.operators), amplitudes=state.numel(), first_ms=first_ms,
                   forward_ms=fwd_ms, state_err=_rel(state, ref))
        marg = (ref.abs() ** 2).reshape(QNN_CUTOFF, -1).sum(1).double().cpu().numpy()
        local_ms, _ = time_ms(lambda: local(), reps=3, warmup=0)
        out['local_forward_ms'] = local_ms
        cir()
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        res, measure_ms = _one_call_ms(lambda: cir.measure(shots=FOCK_SHOTS, generator=gen))
        counts = {}
        for key, v in res.items():
            counts[format(key.state[0], 'b')] = counts.get(format(key.state[0], 'b'), 0) + v
        stat, dof, bar = _chi2(counts, marg, FOCK_SHOTS)
        out.update(measure_ms=measure_ms, chi2=stat, dof=dof)
        noisy = build(noise=True, noise_per_forward=True, sigma=0.05)
        a = noisy(noise_generator=torch.Generator(device='cuda').manual_seed(SEED)).clone()
        b = noisy(noise_generator=torch.Generator(device='cuda').manual_seed(SEED))
        out['noise_bitwise'] = bool(torch.equal(a, b))
        out['noise_moves'] = _rel(a, state)
    del cir, local, noisy, state, ref, a, b
    torch.cuda.empty_cache()
    print(f"sharded Fock CV-QNN {QNN_MODES} modes, cutoff {QNN_CUTOFF}, on {k} shards: "
          f"{out['ops']} ops, {out['amplitudes']} amplitudes; forward {fwd_ms:.1f} ms (first "
          f"{first_ms:.1f}, local tensor {local_ms:.1f}), peak {out['peak_gib']} GiB; state off "
          f"the local tensor {out['state_err']:.1e}; measure({FOCK_SHOTS}) {measure_ms:.1f} ms, mode 0 "
          f"chi-square {stat:.1f} on {dof} dof (bound {bar:.1f}); per-forward noise bitwise over "
          f"two runs of one seed: {out['noise_bitwise']} (it moves the state by "
          f"{out['noise_moves']:.1e}) [{card}]")
    if not (out['state_err'] <= FOCK_STATE_BAR and out['noise_bitwise']
            and out['noise_moves'] > 0):
        raise AssertionError(f'9v: {out}')
    _hold_chi2('9v measure', stat, dof, bar)
    return {}, out

def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--profile', action='store_true',
                    help='instead of the checks, print where one n=18 grad step, one batched '
                         'QML step and one call of each photonic path spend their time')
    ap.add_argument('--out', default=None, help='with --profile: also write the JSON here')
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = setup()
    build()
    if args.profile:
        text = json.dumps(dict(training=profile_training(smi), batched_qml=profile_batched_qml(smi),
                               photonic=profile_photonic(smi)))
        print(text)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(text + '\n')
        return 0
    results: dict = {}
    rng, rng_g = np.random.default_rng(SEED), np.random.default_rng(SEED + 1)
    # no_grad, not inference_mode: a tensor made in inference mode and cached
    # would break the autograd-tracked phases below
    # the photonic phases draw from a generator of their own, so that K1-K6
    # see the inputs they always saw
    rng_p = np.random.default_rng(SEED + 2)
    seconds: dict = {}       # wall seconds of each phase

    @contextlib.contextmanager
    def phase(label: str):
        t0 = time.perf_counter()
        yield
        seconds[label] = round(time.perf_counter() - t0, 1)

    with torch.no_grad():
        with phase('gate_kernels'):
            check_gate_kernels(results, rng, rng_g)
        with phase('batched_kernels'):
            check_batched_kernels(results, np.random.default_rng(SEED + 5))
        with phase('superop_kernels'):
            check_superop_kernels(results, np.random.default_rng(SEED + 9))
        with phase('batched_chain'):
            check_batched_chain(results, np.random.default_rng(SEED + 8))
        with phase('window_kernels'):
            check_window_kernels(results, rng, rng_g)
        with complex128(), phase('photonic_kernels'):
            check_permanent_kernel(results, rng_p)
            check_tor_kernels(results, rng_p)
            check_tor_batched(results, np.random.default_rng(SEED + 7))

    def n18(c):
        if c['window_chain_fwd'] != 2:
            raise AssertionError(f'n=18: window_chain_fwd launched {c["window_chain_fwd"]} times, not 2')

    def n24(c):
        if c['window_apply'] <= 0:
            raise AssertionError('n=24: window_apply was not launched')

    def n22(c):
        if c['planar_apply'] < 5 or c['window_apply'] <= 0:
            raise AssertionError(f'n=22 + cnot(0, 11): launches {c}')

    main_path = {name: 0 for name in KERNELS}

    def add(counts):
        for name, c in counts.items():
            main_path[name] += c

    with phase('slices'):
        for n, extra, expect in [(18, None, n18), (24, None, n24), (22, (0, 11), n22)]:
            add(check_slice(n, extra, expect)[0])
    with phase('training'):
        add(check_training()[0])
    with phase('step_backward'):
        for counts in check_step_backward():
            add(counts)
    with phase('batched_qml'):
        add(check_batched_qml(smi)[0])
        add(check_batched_qml_wide())
    noisy = {}
    for n in (12, 8):
        with phase(f'noisy_n{n}'):
            counts, noisy[f'n={n}'] = check_noisy_step(smi, n)
            add(counts)
    with phase('noisy_qml'):
        counts, noisy['qml'] = check_noisy_qml(smi)
        add(counts)
    with phase('hessian'):
        counts, noisy['hessian'] = check_hessian(smi)
        add(counts)
    with phase('measure'):
        noisy['measure'] = check_measure(smi)
    print(f'noisy circuits, hessian, measure: {json.dumps(noisy)}')
    with phase('photonic_paths'):
        add(check_boson_sampling(smi, rng_p))
        add(check_gbs(smi, rng_p))
        add(check_photonic_gradients(smi, np.random.default_rng(SEED + 6)))
    engine, engine_launches = {}, {}
    for key, check in (('qft', check_qft), ('qcnn', check_qcnn), ('adjoint', check_adjoint),
                       ('conditional', check_conditional)):
        with phase(key):
            counts, engine[key] = check(smi)
            add(counts)
            engine_launches[key] = {k: v for k, v in counts.items() if v}
    with phase('mps'):
        engine['mps'] = check_mps(smi)
    print(f'qubit engine paths (launches per call): {json.dumps(engine_launches)}')
    print(f'qubit engine paths: {json.dumps(engine)}')
    cv = {}
    for key, check in (('graph_gbs', lambda: check_graph_gbs(smi, np.random.default_rng(SEED + 10))),
                       ('lossy_gbs', lambda: check_lossy_gbs(smi)),
                       ('tdm', lambda: check_tdm(smi)), ('bosonic', lambda: check_bosonic(smi))):
        with phase(key):
            counts, cv[key] = check()
            add(counts)
    print(f'continuous-variable paths: {json.dumps(cv)}')
    fock = {}
    with phase('fock_qnn'):
        counts, fock['qnn'], qnn = check_fock_qnn(smi)
        add(counts)
    for key, check in (('fock_dm', lambda: check_fock_dm(smi)),
                       ('fock_mps', lambda: check_fock_mps(smi)),
                       ('fock_homodyne', lambda: check_fock_homodyne(smi, qnn))):
        with phase(key):
            counts, fock[key] = check()
            add(counts)
    del qnn
    print(f'Fock tensor paths: {json.dumps(fock)}')
    toolchain = {}
    for key, check in (('class_api_qasm', check_class_api_qasm), ('cutting', check_cutting),
                       ('mbqc', check_mbqc), ('optimizers', check_optimizers)):
        with phase(key):
            counts, toolchain[key] = check(smi)
            add(counts)
    print(f'qubit toolchain paths: {json.dumps(toolchain)}')
    distributed = {}
    for key, check in (('shardmap', check_shardmap), ('gspmd', check_gspmd),
                       ('sharded_fock', check_sharded_fock)):
        with phase(key):
            counts, distributed[key] = check(smi)
            add(counts)
    print(f'distributed paths: {json.dumps(distributed)}')
    print(f'wall seconds of each phase: {json.dumps(seconds)}')
    for name, c in main_path.items():
        if c <= 0:
            raise AssertionError(f'{name} was not launched on the main paths')

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        # library_ms: window_apply has one (a real block matmul, timed in
        # phase 3), planar_apply and planar_grad have one, single and
        # batched (a torch.einsum over the state viewed around the gate's
        # bits), and tor_dets_cuda has one, single and batched (a batched
        # det per size group). The others have no single PyTorch call:
        # planar_bwd_fused has three outputs, the chains are loops of steps,
        # nothing computes a permanent, and the quadratic form is a det, a
        # solve and a dot
        kernels.append(dict(name=name, route='cuda', source=source, replaces=replaces,
                            launches=main_path[name], max_abs_err=r['max_abs_err'],
                            rel_err=r['rel_err'], plane_rel_err=r['plane_rel_err'], ms=r['ms'],
                            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                            bound_by=r['bound_by'], library_ms=r.get('library_ms'),
                            shape=r['shape'], other_shapes=r.get('other_shapes'),
                            **{k: r[k] for k in ('device_ms', 'cold_ms', 'twin32_rel_err',
                                                 'non_unitary_rel_err', 'depth',
                                                 'shared_planes_ms', 'shared_planes_rel_err',
                                                 'per_step_ms', 'per_step_device_ms', 'per_step',
                                                 'pack_ms', 'cluster', 'clusters', 'superop')
                               if k in r}))
    # computed, not measured: the window body's alternative bounds from the
    # inputs as bound_ms is, and the chains' barriers from their step tables
    derived = {name: {k: results[name][k] for k in ('bound_tf32x3_ms', 'bound_tf32x3_by',
                                                    'table_barriers') if k in results[name]}
               for name in ('window_apply', 'window_chain_fwd', 'window_chain_bwd')}
    print(f'derived from the inputs and the step table, not measured: {json.dumps(derived)}')
    print(f'total: {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
