#!/usr/bin/env python3
"""The rates of the tensor-core instructions the window kernels use, on one card.

    python3 tools/mma_rate.py [--out FILE]

K2, K3 and K4 (csrc/window_mma.cuh) run their products as
mma.sync.m16n8k8 with f64 operands and sums on the FP64 tensor cores. This
builds a kernel per instruction that runs nothing but that instruction,
on register operands, with 8 independent sums a warp (so that the
instruction's latency is hidden), for 4 to 16 warps on every SM, times it
with CUDA events and prints the rate in TFLOP/s (2 M N K operations an
instruction) beside the card's published dense peak of its type: 67
TFLOP/s for FP64, 495 for TF32. Beside m16n8k8 f64 it times m8n8k4 f64,
the only f64 shape before Hopper, and m16n8k8 TF32, the instruction of the
earlier 3xTF32 body. The build goes to
deepquantum_tpu_torch/_build/mma_rate/.
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

# name -> (type, M, N, K, A / B / C registers a thread, published dense peak TFLOP/s)
SHAPES = {
    'm16n8k8_tf32': ('float', 16, 8, 8, 4, 2, 4, 495),
    'm8n8k4_f64': ('double', 8, 8, 4, 1, 1, 2, 67),
    'm16n8k8_f64': ('double', 16, 8, 8, 4, 2, 4, 67),
}


def _kernel(name: str, typ: str, m: int, n: int, k: int, na: int, nb: int, nc: int) -> str:
    f64 = typ == 'double'
    ptx = (f'mma.sync.aligned.m{m}n{n}k{k}.row.col.' + ('f64.f64.f64.f64' if f64 else
                                                       'f32.tf32.tf32.f32'))
    regs = list(range(nc + na + nb))
    d = ', '.join(f'%{i}' for i in regs[:nc])
    a = ', '.join(f'%{i}' for i in regs[nc:nc + na])
    b = ', '.join(f'%{i}' for i in regs[nc + na:])
    outs = ', '.join(f'"+{"d" if f64 else "f"}"(d[s][{i}])' for i in range(nc))
    ins = ', '.join([f'"{"d" if f64 else "r"}"(a[{i}])' for i in range(na)]
                    + [f'"{"d" if f64 else "r"}"(b[{i}])' for i in range(nb)])
    op = 'double' if f64 else 'unsigned'
    cvt = '' if f64 else '__float_as_uint'
    return f"""
__global__ void __launch_bounds__(512) {name}(float* out, int iters) {{
  {op} a[{na}], b[{nb}];
  for (int q = 0; q < {na}; ++q) a[q] = {cvt}(1.0f + threadIdx.x * 1e-3f + q);
  for (int q = 0; q < {nb}; ++q) b[q] = {cvt}(0.5f - threadIdx.x * 1e-3f + q);
  {typ} d[8][{nc}] = {{}};
  for (int i = 0; i < iters; ++i) {{
#pragma unroll
    for (int s = 0; s < 8; ++s) {{
      asm volatile("{ptx} {{{d}}}, {{{a}}}, {{{b}}}, {{{d}}};\\n" : {outs} : {ins});
    }}
  }}
  {typ} acc = 0;
  for (int s = 0; s < 8; ++s)
    for (int q = 0; q < {nc}; ++q) acc += d[s][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = float(acc);
}}
"""


def source() -> str:
    body = '#include <cuda_runtime.h>\n' + ''.join(
        _kernel(name, *spec[:7]) for name, spec in SHAPES.items())
    cases = ''.join(f'    case {i}: {name}<<<blocks, threads, 0, s>>>(o, iters); break;\n'
                    for i, name in enumerate(SHAPES))
    return body + f"""
extern "C" int dq_mma_loop(int which, void* out, int blocks, int threads, int iters, void* stream) {{
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {{
{cases}    default: return 1;
  }}
  return cudaGetLastError();
}}
"""


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
    (OUT_DIR / 'mma_rate.cu').write_text(source())
    lib = OUT_DIR / 'libmma_rate.so'
    subprocess.run([_cuda._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-shared',
                    '-Xcompiler', '-fPIC', '-o', str(lib), str(OUT_DIR / 'mma_rate.cu')],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.dq_mma_loop.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    iters = 4096
    rows = []
    for which, (name, (_, m, n, k, *_, peak)) in enumerate(SHAPES.items()):
        for warps in (4, 8, 16):
            threads = 32 * warps
            out = torch.empty(sms * threads, device='cuda')
            for _ in range(2):
                dll.dq_mma_loop(which, ctypes.c_void_p(out.data_ptr()), sms, threads, iters, stream)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            rc = dll.dq_mma_loop(which, ctypes.c_void_p(out.data_ptr()), sms, threads, iters,
                                 stream)
            b.record()
            b.synchronize()
            if rc:
                raise RuntimeError(f'{name}: CUDA error {rc}')
            ms = a.elapsed_time(b)
            flops = sms * warps * iters * 8 * 2 * m * n * k
            rows.append(dict(instruction=name, warps_per_sm=warps, ms=ms,
                             tflops=flops / ms / 1e9, peak_tflops=peak,
                             share_of_peak=flops / ms / 1e9 / peak))
            print(f'mma.sync {name}, {warps} warps on each of {sms} SMs: {ms:.3f} ms, '
                  f'{flops / ms / 1e9:.1f} TFLOP/s of {peak} [{smi}]')
    text = json.dumps(dict(card=smi, device=torch.cuda.get_device_name(0), rows=rows))
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
