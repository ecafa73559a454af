"""Distributed statevector simulation over a mesh of torch devices (the
JAX package's ``parallel``): one process drives every shard."""

from .circuit import DistributedQubitCircuit
from .sharded import (DistributedQubitState, Mesh, ShardedSimulator, cleanup_distributed, make_mesh,
                      setup_distributed)

__all__ = ['ShardedSimulator', 'make_mesh', 'DistributedQubitCircuit', 'DistributedQubitState',
           'Mesh', 'setup_distributed', 'cleanup_distributed']
