#!/usr/bin/env python3
"""The rate of the tensor-core instruction the window kernels use, on one card.

    python3 tools/mma_rate.py [--out FILE]

K2 and K4 (csrc/window_mma.cuh) run their products as mma.sync.m16n8k8 with
TF32 operands and float32 sums. This builds a kernel that issues nothing but
that instruction, on register operands, with 8 independent sums a warp (so
that the instruction's latency is hidden), for 4 to 16 warps on every SM,
times it with CUDA events and prints the rate in TFLOP/s (2 * 16 * 8 * 8
operations an instruction) beside the card's published dense TF32 peak,
495 TFLOP/s. The build goes to deepquantum_tpu_torch/_build/mma_rate/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / 'deepquantum_tpu_torch' / '_build' / 'mma_rate'

SOURCE = r'''
#include <cuda_runtime.h>
__global__ void mma_loop(float* out, int iters) {
  unsigned a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + q);
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(0.5f - threadIdx.x * 1e-3f + q);
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(d[s][0]), "+f"(d[s][1]), "+f"(d[s][2]), "+f"(d[s][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float acc = 0.f;
  for (int s = 0; s < 8; ++s) acc += d[s][0] + d[s][1] + d[s][2] + d[s][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int dq_mma_loop(void* out, int blocks, int threads, int iters, void* stream) {
  mma_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), iters);
  return cudaGetLastError();
}
'''


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('FAIL: needs a CUDA card')
    sys.path.insert(0, str(ROOT))
    from deepquantum_tpu_torch.ops import _cuda
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / 'mma_rate.cu').write_text(SOURCE)
    lib = OUT_DIR / 'libmma_rate.so'
    subprocess.run([_cuda._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-shared',
                    '-Xcompiler', '-fPIC', '-o', str(lib), str(OUT_DIR / 'mma_rate.cu')],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.dq_mma_loop.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    iters = 4096
    rows = []
    for warps in (4, 8, 16):
        threads = 32 * warps
        out = torch.empty(sms * threads, device='cuda')
        for _ in range(2):
            dll.dq_mma_loop(ctypes.c_void_p(out.data_ptr()), sms, threads, iters, stream)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        rc = dll.dq_mma_loop(ctypes.c_void_p(out.data_ptr()), sms, threads, iters, stream)
        b.record()
        b.synchronize()
        if rc:
            raise RuntimeError(f'CUDA error {rc}')
        ms = a.elapsed_time(b)
        flops = sms * warps * iters * 8 * 2 * 16 * 8 * 8
        rows.append(dict(warps_per_sm=warps, ms=ms, tflops=flops / ms / 1e9,
                         share_of_495=flops / ms / 1e9 / 495))
        print(f'mma.sync m16n8k8 tf32, {warps} warps on each of {sms} SMs: {ms:.3f} ms, '
              f'{flops / ms / 1e9:.1f} TFLOP/s [{smi}]')
    text = json.dumps(dict(card=smi, device=torch.cuda.get_device_name(0), rows=rows))
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
