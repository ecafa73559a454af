"""OpenQASM 2 export and OpenQASM 3 export / import for QubitCircuit.

PyTorch counterpart of ``deepquantum_tpu/qasm.py``, the same text for the
same circuit. Export reads the op list and the circuit's host-side
parameter values, so it never touches the device. Import builds the port's
QubitCircuit on the default device (or ``device``).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ['cir_to_qasm2', 'cir_to_qasm3', 'qasm3_to_cir']

# op name -> (qasm name, controlled-prefix names per #controls)
_Q2_NAMES = {
    'U3Gate': 'u3', 'PhaseShift': 'p', 'PauliX': 'x', 'PauliY': 'y', 'PauliZ': 'z',
    'Hadamard': 'h', 'SGate': 's', 'SDaggerGate': 'sdg', 'TGate': 't', 'TDaggerGate': 'tdg',
    'Rx': 'rx', 'Ry': 'ry', 'Rz': 'rz', 'CNOT': 'cx', 'Swap': 'swap',
    'Rxx': 'rxx', 'Ryy': 'ryy', 'Rzz': 'rzz', 'Toffoli': 'ccx', 'Fredkin': 'cswap',
}
_Q2_CONTROLLED = {
    'u3': 'cu3', 'p': 'cp', 'x': {1: 'cx', 2: 'ccx', 3: 'c3x', 4: 'c4x'},
    'y': 'cy', 'z': 'cz', 'h': 'ch', 's': 'cs', 'sdg': 'csdg',
    'rx': 'crx', 'ry': 'cry', 'rz': 'crz', 'swap': 'cswap',
}


def _op_params(cir, op):
    if not op.pidx:
        return []
    vals = [cir._pvals[i] for i in op.pidx]
    if op.inv:
        vals = [-v for v in vals]
    return vals


def _fmt_params(vals):
    if not vals:
        return ''
    return '(' + ','.join(repr(float(v)) for v in vals) + ')'


def _fmt_qubits(wires):
    return ','.join(f'q[{w}]' for w in wires)


def cir_to_qasm2(cir) -> str:
    """QubitCircuit -> OpenQASM 2 (reference circuit.py:570)."""
    lines = ['OPENQASM 2.0;\ninclude "qelib1.inc";\n']
    if cir.wires_measure or cir.wires_condition:
        lines.append(f'qreg q[{cir.nqubit}];\ncreg c[{cir.nqubit}];\n')
    else:
        lines.append(f'qreg q[{cir.nqubit}];\n')
    for op in cir.operators:
        if op.kind == 'barrier':
            lines.append(f'barrier {_fmt_qubits(op.wires)};\n')
            continue
        if op.kind != 'gate':
            raise ValueError(f'{op.name} is NOT supported')
        if op.condition:
            raise ValueError(f'Conditional mode is NOT supported for {op.name}')
        name = _Q2_NAMES.get(op.name)
        if name is None:
            raise ValueError(f'{op.name} is NOT supported')
        nc = len(op.controls)
        if nc:
            mapped = _Q2_CONTROLLED.get(name)
            if isinstance(mapped, dict):
                mapped = mapped.get(nc)
            elif nc > 1:
                mapped = None
            if mapped is None:
                raise ValueError(f'Too many control bits for {op.name}')
            name = mapped
        params = _fmt_params(_op_params(cir, op))
        lines.append(f'{name}{params} {_fmt_qubits(list(op.controls) + list(op.wires))};\n')
    for wire in cir.wires_measure:
        lines.append(f'measure q[{wire}] -> c[{wire}];\n')
    return ''.join(lines)


_Q3_NAMES = {
    'U3Gate': 'u', 'PhaseShift': 'p', 'PauliX': 'x', 'PauliY': 'y', 'PauliZ': 'z',
    'Hadamard': 'h', 'SGate': 's', 'SDaggerGate': 'sdg', 'TGate': 't', 'TDaggerGate': 'tdg',
    'Rx': 'rx', 'Ry': 'ry', 'Rz': 'rz', 'Swap': 'swap', 'CNOT': 'cx',
    'Toffoli': 'ccx', 'Fredkin': 'cswap', 'Rxx': 'rxx', 'Ryy': 'ryy', 'Rzz': 'rzz',
}


def cir_to_qasm3(cir) -> str:
    """QubitCircuit -> OpenQASM 3 (reference qasm3.py:117)."""
    parts = ['OPENQASM 3.0;', 'include "stdgates.inc";', f'qubit[{cir.nqubit}] q;']
    if cir.wires_measure:
        parts.append(f'bit[{max(cir.wires_measure) + 1}] c;')
    for op in cir.operators:
        if op.kind == 'barrier':
            parts.append('barrier ' + ', '.join(f'q[{w}]' for w in op.wires) + ';')
            continue
        if op.kind == 'channel':
            parts.append(f'// Quantum channels like {op.name} are not part of the OpenQASM 3.0 '
                         'core specification.')
            continue
        name = _Q3_NAMES.get(op.name)
        if name is None:
            decomposed = _static_1q_to_qasm3(op)
            if decomposed is not None:
                parts.extend(decomposed)
            else:
                parts.append(f'// Unsupported gate: {op.name}')
            continue
        vals = _op_params(cir, op)
        param_str = f'({", ".join(map(str, vals))})' if vals else ''
        qubits = ', '.join(f'q[{w}]' for w in list(op.controls) + list(op.wires))
        ctrl = 'ctrl @ ' * len(op.controls)
        parts.append(f'{ctrl}{name}{param_str} {qubits};')
    if cir.wires_measure:
        parts.append('')
        for wire in sorted(cir.wires_measure):
            parts.append(f'c[{wire}] = measure q[{wire}];')
    return '\n'.join(parts)


def _zyz_angles(u):
    """Split a 2x2 unitary into (alpha, theta, phi, lam) with
    U = e^{i alpha} . u3(theta, phi, lam)."""
    u = np.asarray(u, complex)
    theta = 2.0 * np.arctan2(abs(u[1, 0]), abs(u[0, 0]))
    half = theta / 2.0
    if np.sin(half) < 1e-12:               # diagonal
        alpha = float(np.angle(u[0, 0]))
        return alpha, 0.0, 0.0, float(np.angle(u[1, 1])) - alpha
    if np.cos(half) < 1e-12:               # anti-diagonal
        alpha = float(np.angle(u[1, 0]))
        return alpha, float(np.pi), 0.0, float(np.angle(-u[0, 1])) - alpha
    alpha = float(np.angle(u[0, 0]))
    phi = float(np.angle(u[1, 0])) - alpha
    lam = float(np.angle(-u[0, 1])) - alpha
    return alpha, float(theta), phi, lam


def _static_1q_to_qasm3(op):
    """Lower a single-qubit arbitrary-matrix gate to gphase + u3 statements
    (goes beyond reference qasm3.py:81 which drops UAnyGate as a comment)."""
    if op.static_matrix is None or len(op.wires) != 1:
        return None
    mat = np.asarray(op.static_matrix, complex)
    if mat.shape != (2, 2):
        return None
    if op.inv:
        mat = mat.conj().T
    alpha, theta, phi, lam = _zyz_angles(mat)
    ctrls = list(op.controls)
    lines = []
    if abs(np.exp(1j * alpha) - 1.0) > 1e-12:
        if ctrls:
            # controlled global phase = phase gate on the last control
            mods = 'ctrl @ ' * (len(ctrls) - 1)
            qs = ', '.join(f'q[{c}]' for c in ctrls)
            lines.append(f'{mods}p({alpha!r}) {qs};')
        else:
            lines.append(f'gphase({alpha!r});')
    mods = 'ctrl @ ' * len(ctrls)
    qs = ', '.join(f'q[{w}]' for w in list(ctrls) + list(op.wires))
    lines.append(f'{mods}u({theta!r}, {phi!r}, {lam!r}) {qs};')
    return lines


# ---------------------------------------------------------------------------
# OpenQASM 3 import
#
# Feature parity with reference qasm3.py:159-472 (custom gate definitions via
# `gate`/`def` blocks, `inv @` / `ctrl @` / `pow(k) @` modifiers, nested macro
# expansion), but organized differently: the importer below is a small
# statement-stream machine — definitions are collected in one pass, then a
# recursive emitter walks statements carrying an explicit (bindings, controls,
# inverted, power) context instead of re-parsing fake QASM programs.
# ---------------------------------------------------------------------------


def _eval_expr(expr: str, scope: dict | None = None) -> float:
    """Evaluate a QASM arithmetic expression (numbers, pi, + - * / parens)."""
    expr = expr.strip().replace('π', 'pi')
    names = {'pi': np.pi, 'tau': 2 * np.pi, 'euler': np.e}
    if scope:
        names.update(scope)
    tokens = re.findall(r'[A-Za-z_]\w*', expr)
    for t in tokens:
        if not (t in names or t == 'e'):
            raise ValueError(f'Disallowed token in QASM expression: {t!r}')
    if set(expr) - set('0123456789.+-*/() _') - {c for t in tokens for c in t}:
        raise ValueError(f'Disallowed character in QASM expression: {expr!r}')
    return float(eval(expr, {'__builtins__': {}}, names))  # noqa: S307 — sanitized arithmetic


class _GateMacro:
    """A user gate definition: formal params/qubits + body statements."""

    __slots__ = ('name', 'params', 'qubits', 'body')

    def __init__(self, name, params, qubits, body):
        self.name, self.params, self.qubits, self.body = name, params, qubits, body


_SELF_INVERSE = {'x', 'y', 'z', 'h', 'swap', 'cx', 'cz', 'cy', 'ch', 'ccx', 'cswap', 'id'}
_DAGGER_SWAP = {'s': 'sdg', 'sdg': 's', 't': 'tdg', 'tdg': 't'}
_ROTATIONS = {'rx', 'ry', 'rz', 'p', 'phase', 'cp', 'crx', 'cry', 'crz', 'rxx', 'ryy', 'rzz'}


def _split_statements(qasm: str):
    """Strip comments and split into statements, keeping `{...}` blocks whole."""
    text = []
    for raw in qasm.splitlines():
        text.append(raw.split('//')[0])
    text = '\n'.join(text)
    stmts, buf, depth = [], [], 0
    for ch in text:
        if ch == '{':
            depth += 1
        elif ch == '}':
            depth -= 1
            if depth == 0:
                buf.append(ch)
                stmts.append(''.join(buf).strip())
                buf = []
                continue
        elif ch == ';' and depth == 0:
            s = ''.join(buf).strip()
            if s:
                stmts.append(s)
            buf = []
            continue
        buf.append(ch)
    tail = ''.join(buf).strip()
    if tail:
        stmts.append(tail)
    return [' '.join(s.split()) for s in stmts if s.strip()]


_DEF_RE = re.compile(r'^(?:gate|def)\s+(?P<name>\w+)\s*(?:\((?P<params>[^)]*)\))?'
                     r'\s*(?P<qubits>[^{]*)\{(?P<body>.*)\}$', re.S)
_CALL_RE = re.compile(r'^(?P<mods>(?:(?:inv|ctrl|negctrl|pow\s*\([^)]*\))\s*@\s*)*)'
                      r'(?P<name>\w+)\s*(?:\((?P<params>[^)]*)\))?\s*(?P<qubits>.*)$')


def _collect_macros(stmts):
    macros, body = {}, []
    for s in stmts:
        m = _DEF_RE.match(s)
        if m:
            params = [p.strip() for p in (m.group('params') or '').split(',') if p.strip()]
            qubits = [q.strip() for q in m.group('qubits').split(',') if q.strip()]
            macros[m.group('name')] = _GateMacro(
                m.group('name'), params, qubits, _split_statements(m.group('body')))
        else:
            body.append(s)
    return macros, body


def qasm3_to_cir(qasm: str, device=None):
    """OpenQASM 3 -> QubitCircuit (on ``device``, default the default device).

    Parity with reference qasm3.py:166-472: `gate`/`def` definitions (nested
    calls allowed), `inv @`, `ctrl @`, integer and non-integer `pow(x) @`
    (the latter through an eigendecomposition of the sub-unitary), measure
    statements, barriers, and the stdgates builtin set.
    """
    from .circuit import QubitCircuit

    stmts = _split_statements(qasm)
    macros, body = _collect_macros(stmts)

    nqubit = qreg = None
    for s in body:
        m = re.match(r'qubit\[(\d+)\]\s+(\w+)', s) or re.match(r'qubit\s+(\w+)()', s)
        if m and m.group(1).isdigit():
            nqubit, qreg = int(m.group(1)), m.group(2)
            break
        m = re.match(r'qreg\s+(\w+)\[(\d+)\]', s)
        if m:
            nqubit, qreg = int(m.group(2)), m.group(1)
            break
    if nqubit is None:
        raise ValueError('No qubit register found')
    cir = QubitCircuit(nqubit, device=device)
    _emit(cir, body, macros, scope={}, qmap=None, controls=[], inverted=False)
    cir.wires_measure.sort()
    return cir


def _resolve_qubits(qubits_str, qmap):
    """Map operand text to wire indices via the active formal-qubit binding."""
    out = []
    for tok in (t.strip() for t in qubits_str.split(',') if t.strip()):
        if qmap is not None and tok in qmap:
            out.append(qmap[tok])
            continue
        m = re.match(r'\w+\[(\d+)\]$', tok)
        if not m:
            raise ValueError(f'Cannot resolve qubit operand {tok!r}')
        out.append(int(m.group(1)))
    return out


def _emit(cir, stmts, macros, scope, qmap, controls, inverted):
    """Apply statements onto the circuit under the active expansion context."""
    for s in (reversed(stmts) if inverted else stmts):
        if s.startswith(('OPENQASM', 'include', 'qubit', 'qreg', 'bit', 'creg',
                         'defcal', 'cal', 'input', 'output')):
            continue
        if 'measure' in s:
            for m in re.finditer(r'measure\s+\w+\[(\d+)\]', s):
                w = int(m.group(1))
                if w not in cir.wires_measure:
                    cir.wires_measure.append(w)
            continue
        if s.startswith('barrier'):
            rest = s[len('barrier'):].strip()
            wires = _resolve_qubits(rest, qmap) if rest else None
            cir.barrier(wires)
            continue
        gm = re.match(r'^(?P<mods>(?:inv\s*@\s*)*)gphase\s*\(([^)]*)\)$', s)
        if gm:
            a = _eval_expr(gm.group(2), scope)
            if inverted ^ (len(re.findall(r'\binv\b', gm.group('mods') or '')) % 2 == 1):
                a = -a
            if controls:
                # controlled global phase = phase gate on one control
                cir.p(controls[-1], inputs=a, controls=controls[:-1] or None)
            else:
                # e^{ia} I on wire 0: p(a) X p(a) X
                cir.x(0)
                cir.p(0, inputs=a)
                cir.x(0)
                cir.p(0, inputs=a)
            continue
        m = _CALL_RE.match(s)
        if not m or not m.group('qubits').strip():
            continue
        mods = m.group('mods') or ''
        name = m.group('name')
        ninv = len(re.findall(r'\binv\b', mods))
        nctrl = len(re.findall(r'\bctrl\b', mods))
        if 'negctrl' in mods:
            raise ValueError('negctrl modifier is not supported')
        pow_m = re.search(r'pow\s*\(([^)]*)\)', mods)
        power = _eval_expr(pow_m.group(1), scope) if pow_m else 1.0

        operands = _resolve_qubits(m.group('qubits'), qmap)
        inline_controls, targets = operands[:nctrl], operands[nctrl:]
        all_controls = list(controls) + inline_controls
        inv_here = inverted ^ (ninv % 2 == 1)
        if inv_here:
            power = -power
        params_src = [p.strip() for p in (m.group('params') or '').split(',') if p.strip()]

        if power != int(power):
            # non-integer power: eigendecompose the sub-unitary (reference
            # qasm3.py:316-328) and apply it as an arbitrary gate
            u = _sub_unitary(name, params_src, len(targets), macros, scope, cir.device)
            w, v = np.linalg.eig(u)
            u_pow = v @ np.diag(w.astype(complex) ** power) @ np.linalg.inv(v)
            cir.any(u_pow, wires=targets, controls=all_controls or None)
            continue

        # sign of the (inv-folded) power carries the inversion; |power| the
        # repetition count. NOTE: correct QASM3 semantics — the reference's
        # own inv@ handling (qasm3.py:330-334) un-inverts plain `inv @ g`.
        reps = int(abs(power))
        inv_eff = power < 0
        for _ in range(reps):
            if name in macros:
                _expand_macro(cir, macros[name], params_src, targets, macros,
                              scope, all_controls, inv_eff)
            else:
                params = [_eval_expr(p, scope) for p in params_src]
                _apply_builtin(cir, name, params, targets, all_controls, inv_eff)


def _expand_macro(cir, macro, params_src, targets, macros, scope, controls, inverted):
    if len(targets) != len(macro.qubits):
        raise ValueError(f'gate {macro.name} expects {len(macro.qubits)} qubits, '
                         f'got {len(targets)}')
    if len(params_src) != len(macro.params):
        raise ValueError(f'gate {macro.name} expects {len(macro.params)} params, '
                         f'got {len(params_src)}')
    new_scope = dict(scope)
    new_scope.update({f: _eval_expr(p, scope) for f, p in zip(macro.params, params_src)})
    qmap = dict(zip(macro.qubits, targets))
    _emit(cir, macro.body, macros, new_scope, qmap, controls, inverted)


def _sub_unitary(name, params_src, nq, macros, scope, device):
    """Unitary of one gate call, for pow-modifier exponentiation."""
    from .circuit import QubitCircuit
    sub = QubitCircuit(nq, device=device)
    params = [str(_eval_expr(p, scope)) for p in params_src]
    if name in macros:
        _expand_macro(sub, macros[name], params, list(range(nq)), macros, {}, [], False)
    else:
        _apply_builtin(sub, name, [float(p) for p in params], list(range(nq)), [], False)
    return sub.get_unitary().detach().cpu().numpy()


def _apply_builtin(cir, name, params, targets, controls, inverted):
    name = name.lower()
    if inverted:
        if name in _ROTATIONS:
            params = [-p for p in params]
        elif name in ('u', 'u3'):
            params = [-params[0], -params[2], -params[1]]
        elif name in _DAGGER_SWAP:
            name = _DAGGER_SWAP[name]
        elif name not in _SELF_INVERSE:
            raise ValueError(f'Cannot invert builtin gate {name!r}')
    # fold builtin control prefixes into the control list
    fold = {'cx': ('x', 1), 'cz': ('z', 1), 'cy': ('y', 1), 'ch': ('h', 1),
            'ccx': ('x', 2), 'cswap': ('swap', 1), 'cp': ('p', 1),
            'crx': ('rx', 1), 'cry': ('ry', 1), 'crz': ('rz', 1), 'cnot': ('x', 1)}
    if name in fold:
        base, k = fold[name]
        controls = controls + targets[:k]
        targets = targets[k:]
        name = base
    ctrl = controls or None
    if name == 'id':
        return
    if name in ('u', 'u3'):
        cir.u3(targets[0], inputs=params, controls=ctrl)
    elif name in ('p', 'phase'):
        cir.p(targets[0], inputs=params[0], controls=ctrl)
    elif name in ('rx', 'ry', 'rz'):
        getattr(cir, name)(targets[0], inputs=params[0], controls=ctrl)
    elif name in ('rxx', 'ryy', 'rzz'):
        getattr(cir, name)(targets, inputs=params[0], controls=ctrl)
    elif name in ('x', 'y', 'z', 'h', 's', 'sdg', 't', 'tdg'):
        getattr(cir, name)(targets[0], controls=ctrl)
    elif name == 'swap':
        cir.swap(targets, controls=ctrl)
    else:
        raise ValueError(f'Unsupported QASM gate: {name}')
