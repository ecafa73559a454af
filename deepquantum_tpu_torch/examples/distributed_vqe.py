"""VQE over an amplitude-sharded statevector, with resumable checkpoints.

A ``DistributedQubitCircuit`` on a mesh (default ``make_mesh()``: one shard
per visible card; several shards of one card with
``make_mesh(devices=['cuda:0'] * 4)``) trains by Adam; every
``ckpt_every`` steps the parameters, the optimizer's state and the step
number go to a checkpoint (``utils.io.save_train_state``; the state
vector is not saved). Then a restart: fresh parameters and a fresh
optimizer are loaded from the last checkpoint and train on. On CUDA shards
at complex64 every shard's work runs on the planar and window kernels,
with one backward across the exchanges.

    python -m deepquantum_tpu_torch.examples.distributed_vqe
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

from ..config import resolve_device
from ..parallel import DistributedQubitCircuit, make_mesh
from ..utils.io import load_train_state, save_train_state
from . import adam_steps

LR = 0.05


def build(nqubit: int, nlayer: int, mesh) -> DistributedQubitCircuit:
    cir = DistributedQubitCircuit(nqubit, mesh=mesh)
    for _ in range(nlayer):
        for i in range(nqubit):
            cir.rx(i)
            cir.rz(i)
        cir.cnot_ring()
    cir.observable(list(range(nqubit)), basis='x' * nqubit)
    return cir


def main(nqubit: int = 12, nlayer: int = 2, steps: int = 50, ckpt_every: int = 20,
         resume_steps: int = 5, mesh=None, device=None, seed: int | None = None,
         ckpt_dir: str | None = None) -> dict:
    """Train ``steps`` steps from parameters drawn from ``seed``,
    checkpointing every ``ckpt_every``; restart from the last checkpoint
    and train ``resume_steps`` more. Checkpoints go under ``ckpt_dir``
    (default a temporary directory, removed at the end). Returns the value
    <X...X> of every step, the resumed run's values apart, the step it
    resumed at and the mesh size."""
    if mesh is None:
        mesh = make_mesh() if device is None else make_mesh(devices=[resolve_device(device)])
    cir = build(nqubit, nlayer, mesh)
    cir.init_para(seed)
    own_dir = ckpt_dir is None
    root = tempfile.mkdtemp(prefix='dq_vqe_') if own_dir else ckpt_dir
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, 'ckpt.pt')
    try:
        params = cir.params.requires_grad_()
        opt = torch.optim.Adam([params], lr=LR)
        values = []
        for it in range(steps):
            values += adam_steps(lambda: cir.expectation(params=params)[0], opt, 1)
            if (it + 1) % ckpt_every == 0:
                save_train_state(path, dict(params=params.detach(), opt=opt,
                                            step=torch.tensor(it + 1)))
        # ---- a restart: rebuild the training state from the checkpoint
        saved = load_train_state(path)
        params = saved['params'].to(cir.device).requires_grad_()   # a fresh leaf
        opt = torch.optim.Adam([params], lr=LR)
        opt.load_state_dict(saved['opt'])
        start = int(saved['step'])
        resumed = adam_steps(lambda: cir.expectation(params=params)[0], opt, resume_steps)
    finally:
        if own_dir:
            shutil.rmtree(root, ignore_errors=True)
    final = resumed[-1] if resumed else values[-1]
    print(f'{mesh.size} shards, resumed at step {start}, final <X...X> = {final:.6f}')
    return dict(values=values, resumed=resumed, resumed_at=start, final=final, shards=mesh.size,
                params=params.detach())


if __name__ == '__main__':
    main()
