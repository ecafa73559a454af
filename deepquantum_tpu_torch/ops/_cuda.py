"""Build, load and call the port's CUDA kernels.

The kernels live in ``deepquantum_tpu_torch/csrc/*.cu`` and are compiled by
``nvcc`` for ``sm_90a`` into ONE shared library with a plain C interface, at
first use, into ``deepquantum_tpu_torch/_build/<key>/`` where the key is a
hash of the sources and the flags (a changed source rebuilds). The library
is loaded with ``ctypes``: pointers and the stream go as ``c_void_p``, every
entry point takes the device index and PyTorch's current stream last and
returns ``cudaGetLastError()`` after its launch, and a non-zero code raises
here. Nothing in the port catches these errors to fall back on a plain
version: a CUDA tensor runs the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ['build', 'launch', 'launch_on', 'stream_of', 'sm_count', 'check_state',
           'check_planes', 'sample_planes', 'source_key']

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR / '_build'
LIB_NAME = 'libdq_kernels.so'
# --threads 0: nvcc compiles the sources side by side, one thread per CPU
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '--threads', '0',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types before the trailing (device, stream)
_SIGNATURES = {
    # x, mre, mim, batch, pstride, n, k, low, swap, hb[3], bps
    'dq_planar_apply_f32': (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I),
    'dq_window_apply_f32': (_P, _P, _P, _I),                   # x, mre, mim, n
    # table, nstep, wre, wim, a, b, sms, n
    'dq_window_chain_fwd_f32': (_P, _I, _P, _P, _P, _P, _I, _I),
    # g, x, out, parts, count, batch, n, k, low, swap, hb[3], bps
    'dq_planar_grad_f32': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I),
    # y, g, mre_t, mim_t, parts, batch, pstride, nblocks, n, k, bits[3]
    'dq_planar_bwd_fused_f32': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I),
    # table, nstep, wre_t, wim_t, ya, yb, ga, gb, dwre, dwim, part, slots, sms, n
    'dq_window_chain_bwd_f32': (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I),
    'dq_permanent_ryser': (_P, _I, _P, _I, _I, _I),            # mats, is_c64, parts, b, n, level
    # o_mat, gamma (or null), is_c64, idx, det, quad (or null), batch, m
    'dq_tor_lu': (_P, _P, _I, _P, _P, _P, _I, _I),
    # table, nstep, ps_re, ps_im, sh_re, sh_im, pstride, x, y, batch, n, c
    'dq_planar_chain_batched_fwd_f32': (_P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I),
    # table, nstep, ps_re, ps_im, sh_re, sh_im, pstride, y, g, x_out, g_out, parts, fd,
    # batch, n, c
    'dq_planar_chain_batched_bwd_f32': (_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I),
    'dq_planar_chain_batched_clusters': (_I, _I, _I, _P),      # n, c, backward, out (host int)
    'dq_planar_apply_blocks_per_sm': (_I, _I, _P),             # k, low, out (host int)
    'dq_planar_grad_blocks_per_sm': (_I, _I, _P),              # k, low, out (host int)
}

_lock = threading.Lock()
_lib = None
build_log = ''   # compiler output of the last build (ptxas register/spill report)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in ('.cu', '.cuh'))


def source_key() -> str:
    """Hash of the kernel sources and the compiler flags."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = []
    for var in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        cands.append(found)
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels '
                       'of deepquantum_tpu_torch are built from csrc/ at first use')


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless this key is built."""
    global build_log
    out = BUILD_DIR / source_key() / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{LIB_NAME}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-I', str(CSRC_DIR), '-o', str(tmp),
           *[str(p) for p in _sources() if p.suffix == '.cu']]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n{build_log}')
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [*args, _I, _P]
                fn.restype = _I
            lib.dq_error_string.argtypes = [_I]
            lib.dq_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


# the current stream's handle as an int: PyTorch's raw accessor (what its
# own generated kernels call) where the build has it, else the Stream object
_raw_stream = getattr(torch._C, '_cuda_getCurrentRawStream', None)


def stream_of(device: torch.device) -> tuple[int, int]:
    """(device index, handle of its current stream)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if _raw_stream is not None:
        return index, _raw_stream(index)
    return index, torch.cuda.current_stream(index).cuda_stream


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; tensors go
    as their data pointers. Raises on a non-zero CUDA error code."""
    launch_on(name, *stream_of(device), *args)


def launch_on(name: str, index: int, stream: int, *args) -> None:
    """``launch`` on the stream ``stream_of`` gave. Pointers go as plain
    ints (the argtypes make them void*): a c_void_p per argument costs more
    host time than the per-gate kernels take on the card."""
    lib = _lib or _load()
    rc = getattr(lib, name)(*[a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
                              for a in args], index, stream)
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc} ({lib.dq_error_string(rc).decode()})')


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``'s card."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


_GRAD_HINT = ('gradients come from planar_chain and planar_pauli_expectation '
              '(QubitCircuit.forward / expectation with params=)')
TWIN_BACKWARD_HINT = ('gradients come from the wrapper (permanent_cuda_batch, tor_dets_cuda, '
                      'tor_dets_quads_cuda), whose backward differentiates the plain twin')


def _no_grad(name: str, *tensors, hint: str = _GRAD_HINT) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f'{name}: a kernel wrapper is not differentiable when called directly; {hint}. '
            'Detach the tensor or call under torch.no_grad().')


def check_state(x: torch.Tensor, n: int, name: str, batched: bool = False,
                aligned: bool = False) -> int:
    """A kernel's planar state: CUDA float32, contiguous, (2, 2^n), or with
    ``batched`` also a (B, 2, 2^n) stack; with ``aligned`` on a 16-byte
    boundary (the kernels that read float4). Returns the batch count (1 for
    one state)."""
    _no_grad(name, x)
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: state must be a CUDA tensor, got {x.device}')
    if x.dtype != torch.float32:
        raise TypeError(f'{name}: the CUDA kernel takes float32 planes, got {x.dtype}')
    if aligned and x.data_ptr() % 16:
        raise ValueError(f'{name}: state must start on a 16-byte boundary')
    shape = tuple(x.shape)
    if shape == (2, 1 << n) and x.is_contiguous():
        return 1
    if batched and len(shape) == 3 and shape[1:] == (2, 1 << n) and shape[0] >= 1 \
            and x.is_contiguous():
        return shape[0]
    want = f'(2, 2^{n})' + (f' or (B, 2, 2^{n})' if batched else '')
    raise ValueError(f'{name}: state must be contiguous {want}, got {shape}')


def check_planes(name: str, x: torch.Tensor, shape, *planes):
    """Matrix planes on x's device, float32, ``shape``; returned contiguous."""
    _no_grad(name, *planes)
    out = []
    for m in planes:
        if m.device != x.device:
            raise ValueError(f'{name}: matrix planes on {m.device}, state on {x.device}')
        if tuple(m.shape) != tuple(shape):
            raise ValueError(f'{name}: matrix planes must be {tuple(shape)}, got {tuple(m.shape)}')
        out.append(m.to(torch.float32).contiguous())
    return out


def sample_planes(name: str, x: torch.Tensor, batch: int, shape, *planes):
    """The matrix planes of a per-gate kernel on a stack of ``batch`` states:
    each ``shape``, one set for every sample, or (batch, *shape), one per
    sample; a (batch, *shape) view with stride 0 over the samples (an
    ``expand``) counts as one set. Returns (float32 contiguous planes,
    pstride), pstride the floats between two samples' planes (0: one set).
    Planes that already are float32 and contiguous are passed as they are."""
    _no_grad(name, *planes)
    shape = tuple(shape)
    out, shared = [], True
    for m in planes:
        if m.device != x.device:
            raise ValueError(f'{name}: matrix planes on {m.device}, state on {x.device}')
        if m.dtype != torch.float32:
            m = m.to(torch.float32)
        if x.dim() == 3 and m.shape == (batch, *shape):
            if batch == 1 or m.stride(0) == 0:
                m = m[0]
            else:
                shared = False
        elif m.shape != shape:
            want = shape if x.dim() == 2 else f'{shape} or {(batch, *shape)}'
            raise ValueError(f'{name}: matrix planes must be {want}, got {tuple(m.shape)}')
        out.append(m)
    if shared:
        return [m if m.is_contiguous() else m.contiguous() for m in out], 0
    return ([m if m.dim() == 3 and m.is_contiguous() else m.expand(batch, *shape).contiguous()
             for m in out], shape[0] * shape[1])
