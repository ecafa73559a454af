"""The user scripts of ``examples/`` as modules of the port.

Each module has the JAX script's name and a ``main(...)`` whose keyword
arguments default to the script's own sizes and step counts, plus
``device`` (None: the port's default device, the CUDA card) and, where the
script is random, a seed or a ``torch.Generator``. ``main`` returns the
numbers the script prints or asserts, and keeps its assertions. Importing a
module runs nothing; on the card:

    python -m deepquantum_tpu_torch.examples.vqe

and on the CPU, ``deepquantum_tpu_torch.set_device('cpu')`` before ``main``.
Without a card and without that call, ``main`` raises (no example falls
back to the CPU). Training uses ``torch.optim.Adam``, whose update is
optax's (m_hat / (sqrt(v_hat) + eps), eps 1e-8).
"""

from __future__ import annotations

__all__ = ['distributed_vqe', 'gaussian_boson_sampling', 'hhl', 'hybrid_qnn',
           'mbqc_basic_gates', 'onchip_optimizer', 'qaoa', 'state_transfer_1d',
           'unitary_mapper', 'vqe', 'adam_steps']


def adam_steps(loss_fn, opt, steps: int) -> list[float]:
    """``steps`` updates of the optimizer ``opt`` on ``loss_fn()``; the
    loss of each step, taken before its update."""
    values = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        values.append(loss.item())
    return values
