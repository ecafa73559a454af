"""Measurement-based quantum computation: patterns of N / E / M / C
commands over graph states on the device."""

from .command import Command, Correction, Entanglement, Measurement, Node
from .pattern import Pattern
from .state import GraphState, SubGraphState
from .templates import MBQC_TEMPLATES

__all__ = ['Command', 'Node', 'Entanglement', 'Measurement', 'Correction', 'Pattern',
           'GraphState', 'SubGraphState', 'MBQC_TEMPLATES']
