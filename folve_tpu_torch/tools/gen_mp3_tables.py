"""Black-box recovery of the ISO 11172-3 Layer III Huffman tables.

The MP3 Huffman code tables are normative spec DATA (Annex B of ISO
11172-3), not creative code.  Without a copy of the spec or of any
decoder source at hand, this tool recovers the tables
behaviorally from the system libmpg123 (a conformant reference
decoder) by driving it with hand-crafted single-frame probes:

  * a probe frame carries arbitrary main_data bits with
    part2_3_length set to EXACTLY the probe length, so the decoder
    consumes precisely those bits;
  * spectral lines are observed through the PCM output, which is
    LINEAR in the requantized line values, so line occupancy and
    values are solvable from measured per-line basis responses
    (count1 table B probes — its 4-bit complement codes are verified
    behaviorally first);
  * a probe string P is a complete decode unit (codeword + linbits +
    sign bits) iff appending a known count1-quad witness shifts the
    PCM by exactly the line-2 basis response — this detects unit
    boundaries without assuming anything about the table under
    recovery;
  * the code tree is walked depth-first (zero-extensions first), each
    found unit is labeled by least-squares against the line bases
    (magnitudes lie on the m^(4/3) lattice), its codeword is split
    off (linbits width determined by targeted probes), and the whole
    codeword subtree is pruned so escape tails don't explode.

Output: build/folve_tpu_torch/mp3_huffman.inc — the C++ arrays that
native/mp3_codec.cc consumes (this package only reads native/; the file
equals native/mp3_huffman.inc byte for byte, including the header
comment, which names the generator the vendored file came from).  The
decoder itself never touches libmpg123; a gated test re-runs this
recovery and asserts the embedded tables match.

Run:  python -m folve_tpu_torch.tools.gen_mp3_tables
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from folve_tpu_torch.tools.mp3_frames import craft_frame, SILENT
from folve_tpu_torch.tools.mp3_oracle import mpg123_decode

# Where main() writes the tables: the build directory beside the package.
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "folve_tpu_torch")

BIG_TABLES = [1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15, 16, 24]
ALIASES = {17: 16, 18: 16, 19: 16, 20: 16, 21: 16, 22: 16, 23: 16,
           25: 24, 26: 24, 27: 24, 28: 24, 29: 24, 30: 24, 31: 24}
ALIAS_CHECK = [17, 21, 25, 30]  # aliases whose codes+linbits we verify


class Prober:
    def __init__(self):
        self.cache = {}
        self.calls = 0

    def q(self, main_bits: str, **kw) -> np.ndarray:
        key = (main_bits, tuple(sorted(kw.items())))
        if key in self.cache:
            return self.cache[key]
        self.calls += 1
        stream = SILENT + craft_frame(main_bits, **kw) + SILENT + SILENT
        y = mpg123_decode(stream)[:, 0]
        self.cache[key] = y
        return y


def close(a, b, atol=2e-4):
    if a.shape != b.shape:
        return False
    scale = max(1.0, float(np.abs(a).max()), float(np.abs(b).max()))
    return bool(np.abs(a - b).max() <= atol * scale)


def quad_code_b(v, w, x, y):
    return format(~((v << 3) | (w << 2) | (x << 1) | y) & 0xF, "04b")


class Recovery:
    def __init__(self):
        self.p = Prober()
        self._line_basis = {}

    # ---- line bases via count1 table B --------------------------------

    def verify_count1b(self):
        z = self.p.q("1111" * 5, big_values=0, count1table_select=1)
        assert np.abs(z).max() == 0.0, "count1B all-ones should be silent"
        a = self.p.q(quad_code_b(1, 0, 0, 0) + "0",
                     big_values=0, count1table_select=1)
        b = self.p.q(quad_code_b(1, 0, 0, 0) + "1",
                     big_values=0, count1table_select=1)
        assert np.abs(a).max() > 0 and close(a, -b), "sign-bit semantics"

    def line_basis(self, line: int) -> np.ndarray:
        """PCM response of value +1 (sign bit 0) at spectral line."""
        if line in self._line_basis:
            return self._line_basis[line]
        q, pos = divmod(line, 4)
        vals = [0, 0, 0, 0]
        vals[pos] = 1
        bits = "1111" * q + quad_code_b(*vals) + "0"
        y = self.p.q(bits, big_values=0, count1table_select=1)
        assert np.abs(y).max() > 0, f"line {line} basis is silent"
        self._line_basis[line] = y
        return y

    # ---- unit detection / labeling ------------------------------------

    WITNESS = None  # set in __main__ paths via property

    def witness(self):
        # big_values=1 -> count1 region starts at line 2; quad element
        # v lands on line 2.
        return quad_code_b(1, 0, 0, 0) + "0"

    def qbig(self, table, bits):
        return self.p.q(bits, table_select0=table, count1table_select=1)

    def is_unit(self, table, P, qP=None):
        if qP is None:
            qP = self.qbig(table, P)
        qPw = self.qbig(table, P + self.witness())
        delta = qPw - qP
        b2 = self.line_basis(2)
        # The delta is a float32 difference of potentially huge PCM
        # (linbits values reach 15+2^13 -> ~1.7e5 after requantization),
        # so cancellation noise scales with the operand magnitude.  A
        # sloppy match here is gated by the exact-magnitude label check
        # that every accepted unit must also pass.
        atol = max(2e-4, 3e-6 * float(np.abs(qP).max()))
        return (close(delta, b2, atol=atol) or
                close(delta, -b2, atol=atol))

    def label(self, table, bits, qy=None):
        """(x, y) signed values of a unit probe, or None if off-basis."""
        if qy is None:
            qy = self.qbig(table, bits)
        B0, B1 = self.line_basis(0), self.line_basis(1)
        A = np.stack([B0, B1], axis=1)
        coef, *_ = np.linalg.lstsq(A, qy, rcond=None)
        resid = qy - A @ coef
        scale = max(1.0, float(np.abs(qy).max()))
        if np.abs(resid).max() > 5e-3 * scale:
            return None
        vals = []
        for c in coef:
            m = abs(float(c)) ** 0.75
            mi = int(round(m))
            if abs(m - mi) > 0.01 * max(1, mi):
                return None
            vals.append(-mi if c < 0 else mi)
        return tuple(vals)

    # ---- per-table walk ------------------------------------------------

    def parse_unit(self, bits, x, y, L):
        """Split a unit under linbits hypothesis L.  Returns codeword
        or None if inconsistent.  Layout: code, [linbits x][sign x],
        [linbits y][sign y]."""
        ax, ay = abs(x), abs(y)
        pos = len(bits)
        if ay:
            pos -= 1
            if (bits[pos] == "1") != (y < 0):
                return None
        if ay >= 15 and L:
            pos -= L
            if pos < 0 or int(bits[pos : pos + L], 2) != ay - 15:
                return None
        elif ay > 15:
            return None
        if ax:
            pos -= 1
            if pos < 0 or (bits[pos] == "1") != (x < 0):
                return None
        if ax >= 15 and L:
            pos -= L
            if pos < 0 or int(bits[pos : pos + L], 2) != ax - 15:
                return None
        elif ax > 15:
            return None
        if pos <= 0:
            return None
        return bits[:pos]

    def determine_L(self, table, bits, x, y):
        """Find the table's linbits width from one magnitude-15 unit:
        hypothesis L is confirmed iff re-probing with the linbits field
        forced to all-ones yields magnitude 15 + 2^L - 1."""
        ax, ay = abs(x), abs(y)
        for L in range(13, 0, -1):
            code = self.parse_unit(bits, x, y, L)
            if code is None:
                continue
            probe = code
            if ax >= 15:
                probe += "1" * L + "0"
            elif ax:
                probe += "0"
            if ay >= 15:
                probe += "1" * L + "0"
            elif ay:
                probe += "0"
            lab = self.label(table, probe)
            if lab is None:
                continue
            want_x = (15 + (1 << L) - 1) if ax >= 15 else ax
            want_y = (15 + (1 << L) - 1) if ay >= 15 else ay
            if (abs(lab[0]), abs(lab[1])) == (want_x, want_y):
                return L
        return 0

    def walk_table(self, table):
        codes = {}
        L = None  # unknown until the first magnitude-15 unit
        stack = ["1", "0"]
        while stack:
            P = stack.pop()
            if len(P) > 48:
                raise RuntimeError(f"table {table}: depth overflow at {P}")
            skip = False
            for c in codes:
                if P.startswith(c):
                    skip = True  # inside an already-solved unit subtree
                    break
            if skip:
                continue
            qP = self.qbig(table, P)
            if self.is_unit(table, P, qP):
                lab = self.label(table, P, qP)
                assert lab is not None, f"table {table}: unlabelable {P}"
                x, y = lab
                if (abs(x) >= 15 or abs(y) >= 15) and L is None:
                    L = self.determine_L(table, P, x, y)
                code = self.parse_unit(bits=P, x=x, y=y, L=L or 0)
                assert code is not None, f"table {table}: unparsable {P}"
                fx = 15 if abs(x) >= 15 else abs(x)
                fy = 15 if abs(y) >= 15 else abs(y)
                prev = codes.get(code)
                assert prev is None or prev == (fx, fy), (
                    f"table {table}: code {code} ambiguous")
                codes[code] = (fx, fy)
            else:
                stack.append(P + "1")
                stack.append(P + "0")
        # validation: prefix-free, complete, square value space
        kraft = sum(2.0 ** -len(c) for c in codes)
        assert abs(kraft - 1.0) < 1e-9, f"table {table}: kraft {kraft}"
        keys = sorted(codes)
        for i, c in enumerate(keys):
            for d in keys[i + 1:]:
                assert not d.startswith(c), f"prefix clash {c} {d}"
        dims = int(round(len(codes) ** 0.5))
        assert dims * dims == len(codes), (
            f"table {table}: {len(codes)} codes")
        vals = sorted({v for pair in codes.values() for v in pair})
        assert vals == list(range(dims)), f"table {table}: values {vals}"
        return codes, (L or 0), dims


def recover_count1a(rec: Recovery):
    """count1 table A: 16 quads; probe with big_values=0 so quads start
    at line 0.  '1' was verified to absorb as the zero quad, so a probe
    P is quad-aligned iff appending '1's leaves the PCM unchanged."""
    p = rec.p

    def q(bits):
        return p.q(bits, big_values=0, count1table_select=0)

    def aligned(P, qP):
        return close(q(P + "1" * 8), qP)

    units = {}
    stack = ["1", "0"]
    while stack:
        P = stack.pop()
        if len(P) > 12:
            raise RuntimeError(f"count1A depth overflow {P}")
        if any(P.startswith(u) for u in units):
            continue
        qP = q(P)
        if aligned(P, qP):
            units[P] = qP
        else:
            stack.append(P + "1")
            stack.append(P + "0")
    A = np.stack([rec.line_basis(i) for i in range(4)], axis=1)
    codes = {}
    for bits, y in units.items():
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        resid = y - A @ coef
        assert np.abs(resid).max() < 5e-3 * max(1.0, np.abs(y).max()), bits
        vals = []
        for c in coef:
            m = abs(float(c)) ** 0.75
            mi = int(round(m))
            assert abs(m - mi) < 0.02 and mi <= 1, f"count1A value {m}"
            vals.append(-mi if c < 0 else mi)
        ns = sum(1 for v in vals if v)
        code = bits[: len(bits) - ns]
        signs = bits[len(bits) - ns:]
        i = 0
        for v in vals:
            if v:
                assert (signs[i] == "1") == (v < 0), f"count1A sign {bits}"
                i += 1
        quad = tuple(abs(v) for v in vals)
        prev = codes.get(code)
        assert prev is None or prev == quad, f"count1A ambiguous {code}"
        codes[code] = quad
    kraft = sum(2.0 ** -len(c) for c in codes)
    assert len(codes) == 16 and abs(kraft - 1.0) < 1e-9, (
        f"count1A: {len(codes)} codes kraft {kraft}")
    return codes


def emit_cpp(path, big, linbits_all, count1a):
    lines = [
        "// MPEG-1 Layer III Huffman code tables (ISO/IEC 11172-3 Annex B).",
        "// Normative spec DATA, recovered behaviorally from a conformant",
        "// reference decoder by folve_tpu/tools/gen_mp3_tables.py (black-box",
        "// probe frames; see that file's docstring).  Regenerate with:",
        "//   python -m folve_tpu.tools.gen_mp3_tables",
        "// Entry format: {xy, len, code}; xy = (x<<4)|y.",
        "#pragma once",
        "#include <cstdint>",
        "",
        "namespace folve_mp3 {",
        "",
        "struct HuffEntry { uint8_t xy; uint8_t len; uint32_t code; };",
        "",
    ]
    for t in sorted(big):
        codes = big[t]
        dims = int(round(len(codes) ** 0.5))
        lines.append(f"// table {t}: {dims}x{dims}")
        lines.append(f"static const HuffEntry kHuffTab{t}[] = {{")
        row = []
        for code in sorted(codes, key=lambda c: (len(c), c)):
            x, y = codes[code]
            row.append(
                f"{{0x{(x << 4) | y:02x},{len(code)},0x{int(code, 2):x}}}")
            if len(row) == 6:
                lines.append("    " + ",".join(row) + ",")
                row = []
        if row:
            lines.append("    " + ",".join(row) + ",")
        lines.append("};")
        lines.append("")
    lines.append("// count1 table A: xy nibble packs the quad (v,w,x,y)")
    lines.append("static const HuffEntry kHuffCount1A[] = {")
    row = []
    for code in sorted(count1a, key=lambda c: (len(c), c)):
        v, w, x, y = count1a[code]
        nib = (v << 3) | (w << 2) | (x << 1) | y
        row.append(f"{{0x{nib:02x},{len(code)},0x{int(code, 2):x}}}")
        if len(row) == 6:
            lines.append("    " + ",".join(row) + ",")
            row = []
    if row:
        lines.append("    " + ",".join(row) + ",")
    lines.append("};")
    lines.append("")
    # per-table-id dispatch: codes pointer + count + linbits
    lines.append("struct HuffTable { const HuffEntry* e; int n; int linbits; };")
    lines.append("static const HuffTable kHuffTables[32] = {")
    for t in range(32):
        base = ALIASES.get(t, t)
        if base in big:
            lb = linbits_all.get(t, 0)
            lines.append(
                f"    {{kHuffTab{base}, "
                f"(int)(sizeof(kHuffTab{base})/sizeof(HuffEntry)), {lb}}},")
        else:
            lines.append("    {nullptr, 0, 0},  // table %d unused" % t)
    lines.append("};")
    lines.append("")
    lines.append("}  // namespace folve_mp3")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def recover_all(progress=print):
    rec = Recovery()
    rec.verify_count1b()
    progress("count1B verified; recovering count1A...")
    count1a = recover_count1a(rec)
    progress(f"count1A: 16 codes ok ({rec.p.calls} probes)")
    big = {}
    linbits_all = {}
    for t in BIG_TABLES:
        codes, L, dims = rec.walk_table(t)
        big[t] = codes
        linbits_all[t] = L
        progress(f"table {t}: {dims}x{dims} linbits={L} "
                 f"codes={len(codes)} (probes {rec.p.calls})")
    for t in ALIAS_CHECK:
        codes, L, dims = rec.walk_table(t)
        base = ALIASES[t]
        assert codes == big[base], f"table {t} codes != table {base}"
        linbits_all[t] = L
        progress(f"table {t}: shares table {base} codes, linbits={L}")
    # remaining aliases: linbits via determine_L on the base escape code
    for t, base in sorted(ALIASES.items()):
        if t in linbits_all:
            continue
        esc_code = next(c for c, v in big[base].items() if v == (15, 15))
        # find L by probing code + 1^L + sign twice (x and y parts)
        L = None
        for cand in range(13, 0, -1):
            probe = esc_code + "1" * cand + "0" + "1" * cand + "0"
            lab = rec.label(t, probe) if rec.is_unit(t, probe) else None
            if lab is not None:
                m = 15 + (1 << cand) - 1
                if (abs(lab[0]), abs(lab[1])) == (m, m):
                    L = cand
                    break
        assert L is not None, f"alias table {t}: linbits not found"
        linbits_all[t] = L
        progress(f"table {t}: linbits={L} (alias of {base})")
    return big, linbits_all, count1a, rec.p.calls


def main():
    big, linbits_all, count1a, calls = recover_all()
    out = os.path.join(OUT_DIR, "mp3_huffman.inc")
    os.makedirs(OUT_DIR, exist_ok=True)
    emit_cpp(os.path.abspath(out), big, linbits_all, count1a)
    print(f"wrote {os.path.abspath(out)}; total probes {calls}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
