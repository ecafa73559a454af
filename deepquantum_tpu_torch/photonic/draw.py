"""Photonic circuit drawing (reference src/deepquantum/photonic/draw.py).

The port's own copy of ``deepquantum_tpu/photonic/draw.py``: host-side
text, nothing on the device. DrawCircuit renders a QumodeCircuit to SVG
with an inline SVG writer (no svgwrite), in the reference's visual
vocabulary: beam splitters are crossing waveguides with theta / phi
annotations, phase shifts thin teal bars, squeezers / displacers / Kerr
boxes carry their parameter values, delay loops draw the loop-with-N
glyph, photon loss the escaping-wave arrow, and homodyne measurements the
gauge dial (reference draw.py:30-505). DrawClements plots the MZI mesh
with matplotlib, imported on the call (reference draw.py:505).
"""

from __future__ import annotations

import numpy as np

__all__ = ['DrawCircuit', 'DrawClements']

_COLW = 90          # column pitch (x advance per circuit depth unit)
_ROWH = 30          # row pitch per mode
_X0 = 40            # left margin before the first column
_Y0 = 30            # y of mode 0's wire


class _SVG:
    """Tiny stand-in for svgwrite.Drawing (emit-and-join string elements)."""

    def __init__(self):
        self.elements = []
        self.width = 0
        self.height = 0

    def line(self, x1, y1, x2, y2, color='black', width=2, dash=None):
        d = f' stroke-dasharray="{dash}"' if dash else ''
        self.elements.append(
            f'<line x1="{x1:g}" y1="{y1:g}" x2="{x2:g}" y2="{y2:g}" '
            f'stroke="{color}" stroke-width="{width}"{d}/>')

    def polyline(self, points, color='black', width=2):
        pts = ' '.join(f'{x:g},{y:g}' for x, y in points)
        self.elements.append(
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="{width}"/>')

    def rect(self, x, y, w, h, color='#1f77b4', stroke='black', sw=1.5):
        self.elements.append(
            f'<rect x="{x:g}" y="{y:g}" width="{w:g}" height="{h:g}" '
            f'fill="{color}" stroke="{stroke}" stroke-width="{sw}"/>')

    def circle(self, cx, cy, r, color='white', stroke='black', sw=1.2):
        self.elements.append(
            f'<circle cx="{cx:g}" cy="{cy:g}" r="{r:g}" fill="{color}" '
            f'stroke="{stroke}" stroke-width="{sw}"/>')

    def path(self, d, color='black', width=1.5, fill='none', transform=None):
        t = f' transform="{transform}"' if transform else ''
        self.elements.append(
            f'<path d="{d}" stroke="{color}" fill="{fill}" '
            f'stroke-width="{width}"{t}/>')

    def text(self, x, y, s, size=11, color='black'):
        self.elements.append(
            f'<text x="{x:g}" y="{y:g}" font-size="{size}" fill="{color}" '
            f'font-family="monospace">{s}</text>')

    def render(self) -> str:
        return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{self.width}" '
                f'height="{self.height}">' + ''.join(self.elements) + '</svg>')


# short label, fill color, and parameter-name list per op (reference
# draw.py:15 info_dic + the per-op draw_* methods' label conventions)
_BOX_STYLE = {
    'PhaseShift': ('PS', 'teal', ('θ',)),
    'Squeezing': ('S', 'royalblue', ('r', 'θ')),
    'Squeezing2': ('S2', 'royalblue', ('r', 'θ')),
    'Displacement': ('D', 'green', ('r', 'θ')),
    'DisplacementPosition': ('X', 'green', ('x',)),
    'DisplacementMomentum': ('Z', 'green', ('p',)),
    'QuadraticPhase': ('QP', 'peru', ('s',)),
    'CubicPhase': ('CP', 'peru', ('γ',)),
    'Kerr': ('K', 'pink', ('κ',)),
    'CrossKerr': ('CK', 'pink', ('κ',)),
    'ControlledX': ('CX', 'gold', ('s',)),
    'ControlledZ': ('CZ', 'gold', ('s',)),
}

_BS_LABELS = {
    'BeamSplitter': 'BS', 'MZI': 'MZI',
    'BeamSplitterTheta': 'BS-T', 'BeamSplitterPhi': 'BS-P',
    'BeamSplitterSingle_rx': 'BS-RX', 'BeamSplitterSingle_ry': 'BS-RY',
    'BeamSplitterSingle_h': 'BS-H',
}


def _fmt(v) -> str:
    return str(np.round(float(v), 3))


class DrawCircuit:
    """SVG renderer for QumodeCircuit (reference photonic/draw.py:30).

    ``params``: the circuit's FULL host parameter vector (``_pvals``); each
    op's ``pidx`` indexes into it for the θ/ϕ/r/κ annotation values.
    """

    def __init__(self, circuit_name: str | None, nmode: int, operators,
                 measurements=None, params=None):
        self.name = circuit_name or 'circuit'
        self.nmode = nmode
        self.operators = operators
        self.measurements = measurements or []
        self.params = None if params is None else np.asarray(params, np.float64)
        self.svg = None
        self.depth = None

    # ------------------------------------------------------------- helpers
    def _vals(self, op):
        if self.params is None or not op.pidx:
            return []
        return [float(self.params[i]) for i in op.pidx]

    @staticmethod
    def _xy(order, wire):
        return _X0 + _COLW * order, _Y0 + _ROWH * wire

    def _wire_seg(self, svg, order, wire):
        x, y = self._xy(order, wire)
        svg.line(x, y, x + _COLW, y)

    # ------------------------------------------------------------- glyphs
    def _draw_bs(self, svg, label, order, wires, vals):
        x, y_up = self._xy(order, min(wires))
        dy = _ROWH * (max(wires) - min(wires))
        # two crossing waveguides (reference draw_bs polylines)
        svg.polyline([(x, y_up), (x + 20, y_up), (x + 50, y_up + dy),
                      (x + 90, y_up + dy)])
        svg.polyline([(x, y_up + dy), (x + 20, y_up + dy), (x + 50, y_up),
                      (x + 90, y_up)])
        svg.text(x + 30 - 3 * max(len(label) - 2, 0), y_up - 5, label, size=9)
        if vals:
            svg.text(x + 45, y_up + dy + 14, 'θ=' + _fmt(vals[0]), size=7)
        if len(vals) > 1:
            svg.text(x + 45, y_up + dy + 20, 'ϕ=' + _fmt(vals[1]), size=7)

    def _draw_box(self, svg, label, color, pnames, order, wires, vals):
        x, y_up = self._xy(order, min(wires))
        for w in wires:
            self._wire_seg(svg, order, w)
        h = 12 if len(set(wires)) == 1 else _ROWH * (max(wires) - min(wires)) + 12
        svg.rect(x + 42.5, y_up - 5, 6 if label == 'PS' else 10, h, color)
        svg.text(x + 40, y_up - 10, label, size=9)
        for k, (pn, v) in enumerate(zip(pnames, vals)):
            svg.text(x + 55, y_up - 12 + 6 * k, f'{pn}={_fmt(v)}', size=7)

    def _draw_any(self, svg, label, order, wires):
        x, y_up = self._xy(order, min(wires))
        h = _ROWH * (max(wires) - min(wires)) + 20
        for w in range(min(wires), max(wires) + 1):
            y = _Y0 + _ROWH * w
            svg.line(x, y, x + 20, y)
            svg.line(x + 70, y, x + 90, y)
        svg.rect(x + 20, y_up - 10, 50, h, 'cadetblue', sw=2)
        svg.text(x + 40, y_up - 15 + h / 2 + 4, label[:6], size=10)

    def _draw_delay(self, svg, order, wires, ntau, vals):
        x, y = self._xy(order, wires[0])
        self._wire_seg(svg, order, wires[0])
        svg.circle(x + 46, y - 9, 9)                  # the fiber loop
        svg.text(x + 40, y - 12, f'N={ntau}', size=5)
        if vals:
            svg.text(x + 58, y - 12, 'θ=' + _fmt(vals[0]), size=6)
        if len(vals) > 1:
            svg.text(x + 58, y - 6, 'ϕ=' + _fmt(vals[1]), size=6)

    def _draw_loss(self, svg, order, wires, theta):
        x, y = self._xy(order, wires[0])
        self._wire_seg(svg, order, wires[0])
        # escaping zig-zag wave with an arrowhead, rotated off the wire
        x0, y0 = x + 18, y - 7
        pts, amp = [f'M {x0:g},{y0:g}'], (1.5, 1.5, 1.5, 3, 3, 1.5, 1.5, 1.5)
        for i in range(8):
            pts.append(f'L {x0 + (i + 1) * 2.5:g},{y0 + (-1) ** i * amp[i]:g}')
        pts.append(f'L {x0 + 24:g},{y0:g} l 4,-2 l 0,4 z')
        svg.path(' '.join(pts), color='gray', width=1.6,
                 transform=f'rotate(-45 {x + 10:g} {y - 12:g})')
        t = float(np.cos(theta / 2) ** 2) if theta is not None else None
        if t is not None:
            svg.text(x + 48, y - 8, 'T=' + _fmt(t), size=7)

    def _draw_homodyne(self, svg, order, wire, phi):
        x, y = self._xy(order, wire)
        self._wire_seg(svg, order, wire)
        # gauge dial: black square, white arc + 45° needle (reference
        # draw_homodyne)
        svg.rect(x + 42.5, y - 5, 14, 14, 'black')
        cx, cy = x + 49.5, y + 2
        svg.path(f'M {cx - 6:g} {cy + 3:g} A 6 6 0 0 1 {cx + 6:g} {cy + 3:g}',
                 color='white')
        svg.path(f'M {cx:g} {cy + 3:g} L {cx:g} {cy - 6:g}', color='white',
                 transform=f'rotate(45 {cx:g} {cy:g})')
        svg.text(x + 40, y - 10, 'M', size=9)
        if phi is not None:
            svg.text(x + 55, y - 10, 'ϕ=' + _fmt(phi), size=7)

    def _draw_barrier(self, svg, order, wires):
        x = _X0 + _COLW * order
        y_top = _Y0 + _ROWH * min(wires) - 15
        y_bot = _Y0 + _ROWH * max(wires) + 15
        svg.line(x, y_top, x, y_bot, dash='5,5')

    # --------------------------------------------------------------- draw
    def draw(self) -> str:
        svg = _SVG()
        depth = [0] * self.nmode
        # (wire, column) cells a glyph already rendered its own wire art for
        covered: set[tuple[int, int]] = set()

        for op in self.operators:
            wires = sorted(op.wires)
            vals = self._vals(op)
            if op.kind == 'barrier':
                order = max([depth[w] for w in wires], default=0)
                self._draw_barrier(svg, order, wires or list(range(self.nmode)))
                for w in wires:
                    depth[w] = order
                continue
            if op.name in _BS_LABELS:
                order = max(depth[w] for w in wires)
                self._draw_bs(svg, _BS_LABELS[op.name], order, wires, vals)
                for w in wires:
                    covered.add((w, order))
                    depth[w] = order + 1
                continue
            if op.kind == 'delay' or op.name.startswith('Delay'):
                order = depth[wires[0]]
                self._draw_delay(svg, order, wires,
                                 op.extra.get('ntau', 1), vals)
                covered.add((wires[0], order))
                depth[wires[0]] = order + 1
                continue
            if op.kind == 'loss' or op.name == 'PhotonLoss':
                order = depth[wires[0]]
                self._draw_loss(svg, order, wires, vals[0] if vals else None)
                covered.add((wires[0], order))
                depth[wires[0]] = order + 1
                continue
            if op.name in _BOX_STYLE:
                label, color, pnames = _BOX_STYLE[op.name]
                # multi-wire boxes claim the whole spanned range's column
                span = (wires if len(wires) == 1
                        else list(range(min(wires), max(wires) + 1)))
                order = max(depth[w] for w in span)
                self._draw_box(svg, label, color, pnames, order, wires, vals)
                for w in span:
                    covered.add((w, order))
                    depth[w] = order + 1
                continue
            # arbitrary / unknown unitary: wide labeled box over the span
            span = list(range(min(wires), max(wires) + 1))
            order = max(depth[w] for w in span)
            self._draw_any(svg, 'U' if op.static_unitary is not None
                           else op.name, order, span)
            for w in span:
                covered.add((w, order))
                depth[w] = order + 1

        for m in self.measurements:
            phi = getattr(m, 'phi', None)
            for w in m.wires:
                order = depth[w]
                self._draw_homodyne(svg, order, w, phi)
                covered.add((w, order))
                depth[w] = order + 1

        ncol = max(max(depth), 1)
        # plain wire segments everywhere no glyph drew its own
        for w in range(self.nmode):
            for c in range(ncol):
                if (w, c) not in covered:
                    self._wire_seg(svg, c, w)
            svg.text(8, _Y0 + _ROWH * w + 4, str(w), size=12)

        svg.width = _X0 + _COLW * ncol + 40
        svg.height = _Y0 + _ROWH * self.nmode + 20
        self.depth = depth
        self.svg = svg.render()
        return self.svg

    def save(self, filename: str) -> None:
        if self.svg is None:
            self.draw()
        with open(filename, 'w') as f:
            f.write(self.svg)


class DrawClements:
    """Matplotlib plot of a Clements MZI mesh (reference photonic/draw.py:505)."""

    def __init__(self, nmode: int, mzi_info, cl: str = 'dodgerblue', method: str = 'cssr'):
        self.nmode = nmode
        self.method = method
        self.color = cl
        self.mzi_info = mzi_info
        self.dic_mzi = mzi_info[1] if isinstance(mzi_info, tuple) else mzi_info

    def plot(self, filename: str | None = None):
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(1.2 * self.nmode, 0.8 * self.nmode))
        for i in range(self.nmode):
            ax.plot([0, self.nmode + 1], [-i, -i], color='gray', lw=1)
            ax.text(-0.4, -i, f'{i}', va='center')
        col_count = {}
        for (a, b), angles in self.dic_mzi.items():
            for k in range(len(angles)):
                col = col_count.get((a, b), 0)
                x = 1 + 2 * col + (a % 2)
                ax.plot([x, x + 1], [-a, -b], color=self.color, lw=2)
                ax.plot([x, x + 1], [-b, -a], color=self.color, lw=2)
                ang = angles[k]
                try:
                    ax.text(x + 0.5, -(a + b) / 2 + 0.25,
                            f'{float(np.asarray(ang).reshape(-1)[0]):.2f}',
                            fontsize=7, ha='center', color='dimgray')
                except (TypeError, ValueError):
                    pass
                col_count[(a, b)] = col + 1
        ax.axis('off')
        if filename:
            fig.savefig(filename, bbox_inches='tight')
        return fig
