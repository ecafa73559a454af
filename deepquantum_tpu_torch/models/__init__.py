"""Algorithm circuits and layered ansatze of the port."""

from .ansatz import (HHL, Ansatz, ControlledMultiplier, ControlledUa, NumberEncoder, PhiAdder,
                     PhiModularAdder, QuantumConvolutionalNeuralNetwork, QuantumFourierTransform,
                     QuantumPhaseEstimation, QuantumPhaseEstimationSingleQubit, RandomCircuitG3,
                     ShorCircuit, ShorCircuitFor15, make_gate)
from .layered import make_layered_vqe

__all__ = ['Ansatz', 'ControlledMultiplier', 'ControlledUa', 'HHL', 'NumberEncoder', 'PhiAdder',
           'PhiModularAdder', 'QuantumConvolutionalNeuralNetwork', 'QuantumFourierTransform',
           'QuantumPhaseEstimation', 'QuantumPhaseEstimationSingleQubit', 'RandomCircuitG3',
           'ShorCircuit', 'ShorCircuitFor15', 'make_gate', 'make_layered_vqe']
