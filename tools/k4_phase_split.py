#!/usr/bin/env python3
"""Where the time of K4 (window_chain_bwd) goes, phase by phase, on one card.

    python3 tools/k4_phase_split.py [--out FILE]

Builds a copy of csrc/window_chain_bwd.cu with per-block clocks inserted at
the phase boundaries by text anchors: thread 0 of each block stamps clock64() at every
boundary (globaltimer at the start and the end, to turn cycles into time).
It runs the build on the n=18 bench sequence of chip_smoke.py (the shape
phase 3 times), 20 timed launches with CUDA events after 2 warm-ups, reads
the stamps of the last launch and prints the mean over blocks of the time
each block spent in each phase:

  1 window products (x = W^H y and g' = W^H g with their stores), 2 dW
    (the block's partial), 3 relabels, 4 waiting in grid.sync() (load
    imbalance and the barrier itself), 5 the reduction of the dW partials.

It counts the grid barriers of a launch from the stamps (label 4), and
times the barrier floor: a cooperative kernel of the same grid and shared
memory that does nothing but grid.sync(), per barrier. The production
sources and build are untouched: the clocks exist only in the copy, under
deepquantum_tpu_torch/_build/k4_phase_split/. (K4's first design, which
included the since deleted csrc/window_tile.cuh, is no longer split.)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / 'deepquantum_tpu_torch' / 'csrc'
OUT_DIR = ROOT / 'deepquantum_tpu_torch' / '_build' / 'k4_phase_split'
CAP = 1024   # stamps per block
LABELS = {1: 'window products', 2: 'dW', 3: 'relabels', 4: 'barrier wait', 5: 'dW reduction'}

PRELUDE = r'''
#include <cstdint>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
__device__ unsigned long long* dq_stamp_buf;
__device__ int dq_stamp_cap;
__device__ __forceinline__ unsigned long long dq_gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define DQ_STAMP_PUT(label, value)                                                       \
  do {                                                                                   \
    if (threadIdx.x == 0 && dq_stamp_buf != nullptr && dq_nst < dq_stamp_cap) {           \
      dq_stamp_buf[(unsigned long long)blockIdx.x * dq_stamp_cap + dq_nst++] =           \
          ((unsigned long long)(label) << 56) | ((value) & 0xFFFFFFFFFFFFFFull);         \
    }                                                                                    \
  } while (0)
#define DQ_STAMP_INIT()            \
  int dq_nst = 0;                  \
  DQ_STAMP_PUT(0xFE, dq_gtimer()); \
  DQ_STAMP_PUT(0, clock64())
#define DQ_STAMP(label) DQ_STAMP_PUT(label, clock64())
#define DQ_STAMP_END()             \
  DQ_STAMP_PUT(0xFD, clock64());   \
  DQ_STAMP_PUT(0xFF, dq_gtimer())
extern "C" int dq_k4_set_stamps(void* buf, int cap) {
  cudaMemcpyToSymbol(dq_stamp_buf, &buf, sizeof(buf));
  cudaMemcpyToSymbol(dq_stamp_cap, &cap, sizeof(int));
  return cudaGetLastError();
}
__global__ void dq_sync_floor_kernel(int iters) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}
extern "C" int dq_k4_sync_floor(int blocks, int threads, int smem, int iters, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(dq_sync_floor_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&iters};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dq_sync_floor_kernel), dim3(blocks),
                                    dim3(threads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
'''

# (anchor, replacement) at the phase boundaries; every anchor must occur
# exactly once in the source
ANCHORS = [
    ('  cg::grid_group grid = cg::this_grid();\n',
     '  cg::grid_group grid = cg::this_grid();\n  DQ_STAMP_INIT();\n'),
    ('      pending = -1;\n', '      pending = -1;\n      DQ_STAMP(5);\n'),
    ('        dq::mma::store_product<TC>(acc, gcur, N, R, c0);\n        __syncthreads();\n',
     '        dq::mma::store_product<TC>(acc, gcur, N, R, c0);\n        __syncthreads();\n'
     '        DQ_STAMP(1);\n'),
    ('        __syncthreads();   // the tiles are reloaded for the next item\n',
     '        __syncthreads();\n        DQ_STAMP(2);\n'),
    ('      gnxt = tmp;\n', '      gnxt = tmp;\n      DQ_STAMP(3);\n'),
    ('      grid.sync();\n', '      grid.sync();\n      DQ_STAMP(4);\n'),
    ('                    dwim + pending * kPlane);\n  }\n  dq::mma::cp_async_wait<0>();\n',
     '                    dwim + pending * kPlane);\n    DQ_STAMP(5);\n  }\n'
     '  dq::mma::cp_async_wait<0>();\n  DQ_STAMP_END();\n'),
]


def build(name: str, source: str):
    from deepquantum_tpu_torch.ops import _cuda
    for anchor, repl in ANCHORS:
        if source.count(anchor) != 1:
            raise SystemExit(f'{name}: anchor not found once: {anchor!r}')
        source = source.replace(anchor, repl)
    out = OUT_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    (out / 'k4.cu').write_text(PRELUDE + source)
    lib = out / 'libk4.so'
    cmd = [_cuda._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
           '-shared', '-Xcompiler', '-fPIC', '-I', str(CSRC), '-o', str(lib), str(out / 'k4.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f'nvcc failed for {name}:\n{proc.stdout}{proc.stderr}')
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    types = [P, I, P, P, P, P, P, P, P, P, P, I, I, I]
    dll.dq_window_chain_bwd_f32.argtypes = types + [I, P]
    dll.dq_window_chain_bwd_f32.restype = I
    dll.dq_k4_set_stamps.argtypes = [P, I]
    dll.dq_k4_set_stamps.restype = I
    dll.dq_k4_sync_floor.argtypes = [I, I, I, I, P]
    dll.dq_k4_sync_floor.restype = I
    return dll


def split_stamps(stamps: np.ndarray) -> dict:
    """Mean over blocks of the time between consecutive stamps, by the label
    of the stamp that ends each stretch; cycles to microseconds by each
    block's globaltimer."""
    mask = (1 << 56) - 1
    per_block, barriers = [], None
    for row in stamps:
        row = [int(v) for v in row if v]
        if not row:
            continue
        labels = [v >> 56 for v in row]
        vals = [v & mask for v in row]
        clk = [(lab, v) for lab, v in zip(labels, vals) if lab < 0xF0 or lab == 0xFD]
        gt = {lab: v for lab, v in zip(labels, vals) if lab in (0xFE, 0xFF)}
        cycles = (clk[-1][1] - clk[0][1]) & mask
        ns = (gt[0xFF] - gt[0xFE]) & mask
        us_per_cycle = ns / cycles / 1e3 if cycles else 0.0
        sums = {lab: 0.0 for lab in LABELS}
        for (_, a), (lab, b) in zip(clk, clk[1:]):
            if lab in sums:
                sums[lab] += ((b - a) & mask) * us_per_cycle
        sums['total'] = ns / 1e3
        per_block.append(sums)
        if barriers is None:
            barriers = labels.count(4)
    keys = list(LABELS) + ['total']
    mean = {LABELS.get(k, k): float(np.mean([b[k] for b in per_block])) for k in keys}
    return dict(blocks=len(per_block), barriers_per_call=barriers, mean_us_per_block=mean)


def run_variant(name, dll, table_rows, args, n, reps=20):
    import torch
    from deepquantum_tpu_torch.ops import chain_kernel as ck
    dev = torch.device('cuda')
    (wre_t, wim_t, y, g, n_win) = args
    table = torch.tensor(table_rows, dtype=torch.int32, device=dev)
    ya, ga = y.clone(), g.clone()
    yb, gb = torch.empty_like(ya), torch.empty_like(ga)
    dw = torch.empty((2, n_win, 128, 128), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = ck._bwd_slots(n, sms)
    part = torch.empty((2, slots, 2, 128, 128), dtype=torch.float32, device=dev)
    stamps = torch.zeros((1024, CAP), dtype=torch.int64, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())

    def call():
        ya.copy_(y)
        ga.copy_(g)
        rc = dll.dq_window_chain_bwd_f32(p(table), len(table_rows), p(wre_t), p(wim_t), p(ya),
                                         p(yb), p(ga), p(gb), p(dw[0]), p(dw[1]), p(part), slots,
                                         sms, n, 0, stream)
        if rc:
            raise RuntimeError(f'{name}: CUDA error {rc}')

    for stamped in (False, True):
        rc = dll.dq_k4_set_stamps(p(stamps) if stamped else None, CAP)
        if rc:
            raise RuntimeError(f'{name}: setting the stamp buffer failed ({rc})')
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            stamps.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        if stamped:
            t_stamped = float(np.median(times))
        else:
            t_plain = float(np.median(times))
    # the copies of y and g into the work buffers are inside the timed region:
    # time them alone and take them off
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        ya.copy_(y)
        ga.copy_(g)
    b.record()
    b.synchronize()
    t_copy = a.elapsed_time(b) / reps
    out = split_stamps(stamps.cpu().numpy().view(np.uint64))
    # the shared memory of a block at n = 18, so that the floor's grid sits
    # on the card as the kernel's does
    smem = 4 * (2 * 128 * 128 + 2 * 2 * 128 * 24)
    iters = 200
    blocks = out['blocks']
    for _ in range(2):
        rc = dll.dq_k4_sync_floor(blocks, 256, smem, iters, stream)
        if rc:
            raise RuntimeError(f'sync floor: CUDA error {rc}')
    torch.cuda.synchronize()
    a.record()
    dll.dq_k4_sync_floor(blocks, 256, smem, iters, stream)
    b.record()
    b.synchronize()
    floor_us = a.elapsed_time(b) * 1e3 / iters
    out.update(kernel_ms=t_plain - t_copy, kernel_ms_with_clocks=t_stamped - t_copy,
               copies_ms=t_copy, table_rows=len(table_rows),
               barrier_floor_us=floor_us, barrier_floor_ms_per_call=floor_us * out['barriers_per_call'] / 1e3)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('FAIL: needs a CUDA card')
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from deepquantum_tpu_torch.ops import chain_kernel as ck
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f'card: {smi}')
    n = 18
    with torch.no_grad():
        cir = cs.bench_circuit(n)
        mres, mims, wseq = cir._planar_seq(cir._full_params())
        rows, win_steps = ck._step_table(wseq, n, backward=True)
        wre_t = torch.stack([mres[i] for i in win_steps]).transpose(1, 2).contiguous()
        wim_t = (-torch.stack([mims[i] for i in win_steps]).transpose(1, 2)).contiguous()
        rng = np.random.default_rng(cs.SEED)
        y = cs._randn_state(n, rng, torch.device('cuda'))
        g = cs._randn_state(n, rng, torch.device('cuda'))
        data = (wre_t, wim_t, y, g, len(win_steps))
        result = dict(card=smi, device=torch.cuda.get_device_name(0), n=n, steps=len(rows),
                      windows=len(win_steps))
        name = 'redesign'
        t0 = time.perf_counter()
        dll = build(name, (CSRC / 'window_chain_bwd.cu').read_text())
        print(f'{name}: built in {time.perf_counter() - t0:.1f} s')
        result[name] = run_variant(name, dll, ck._merged_rows(rows, n), data, n)
        print(f'{name}: {json.dumps(result[name])}')
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
