"""Parser for the jconvolver filter-config language.

Grammar and behaviors follow the reference's config compiler
(zita-config.cc:282-342 dispatch; README.CONFIG.txt): lines starting
with ``/`` are commands; blank lines and ``#`` comments are ignored;
anything else is a syntax error.  Commands:

    /cd <dir>
    /convolver/new  <ninp> <nout> <partsize> <maxsize> [density]
    /impulse/read   <in> <out> <gain> <delay> <offset> <length> <chan> <file>
    /impulse/dirac  <in> <out> <gain> <delay>
    /impulse/hilbert <in> <out> <gain> <delay> <length>
    /impulse/copy   <dst-in> <dst-out> <src-in> <src-out>
    /input/name ... | /output/name ...   (accepted, ignored)

The ``partsize`` field of ``/convolver/new`` is parsed but *ignored* —
the reference derives its uniform partition length from maxsize alone
(zita-fconfig.cc:74-77); we preserve that.

Error model mirrors the reference exactly, including its quirk: "other"
errors (unreadable IR file, out-of-range channel counts, bad density)
abort the remainder of the file but the parse still *succeeds* with the
partial filter (zita-config.cc:306 loop condition + :345
``if (stat == ERR_OTHER) stat = 0``).  Syntax/parameter/IO-number errors
are fatal.  Warnings (sample-rate mismatch, truncation) never stop the
parse.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Union

from folve_tpu_torch.filters.sstring import sstring

MAX_DENSITY = 1.0


class ZitaConfigError(Exception):
    """Fatal config error (reference: ERR_SYNTAX/ERR_PARAM/ERR_COMMAND/
    ERR_NOCONV/ERR_IONUM paths of zita-config.cc:346-375)."""

    def __init__(self, path: str, line: int, message: str):
        super().__init__(f"{path}:{line}: {message}")
        self.path = path
        self.line = line


@dataclasses.dataclass
class ConvolverDecl:
    ninp: int
    nout: int
    size: int
    density: float = 0.0


@dataclasses.dataclass
class ReadOp:
    inp: int  # 1-based, like the config language
    out: int
    gain: float
    delay: int
    offset: int
    length: int  # 0 = to end of file
    channel: int  # 1-based channel within the IR file
    path: str  # already resolved against /cd directory
    line: int = 0


@dataclasses.dataclass
class DiracOp:
    inp: int
    out: int
    gain: float
    delay: int
    line: int = 0


@dataclasses.dataclass
class HilbertOp:
    inp: int
    out: int
    gain: float
    delay: int
    length: int
    line: int = 0


@dataclasses.dataclass
class CopyOp:
    dst_inp: int
    dst_out: int
    src_inp: int
    src_out: int
    line: int = 0


ImpulseOp = Union[ReadOp, DiracOp, HilbertOp, CopyOp]


@dataclasses.dataclass
class FilterSpec:
    """Parsed (but not yet compiled) filter configuration."""

    path: str
    convolver: Optional[ConvolverDecl] = None
    ops: List[ImpulseOp] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)

    def warn(self, msg: str):
        self.warnings.append(msg)


_UINT = re.compile(r"\s*(\d+)")
_INT = re.compile(r"\s*([+-]?\d+)")
_FLOAT = re.compile(r"\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")


def _scan(line: str, kinds: str) -> Optional[tuple[list, int]]:
    """sscanf-lite: consume fields per ``kinds`` ('u'=uint, 'f'=float).

    Returns (values, end_position) or None if any field fails — matching
    the reference's all-or-nothing sscanf return checks.
    """
    vals = []
    pos = 0
    for k in kinds:
        pat = _UINT if k == "u" else _FLOAT
        m = pat.match(line, pos)
        if not m:
            return None
        vals.append(int(m.group(1)) if k == "u" else float(m.group(1)))
        pos = m.end()
    return vals, pos


class _AbortOther(Exception):
    """Non-fatal abort: stop parsing, keep partial config (ERR_OTHER)."""


def parse_config(path: str, text: Optional[str] = None) -> FilterSpec:
    """Parse a filter config file into a :class:`FilterSpec`.

    Raises :class:`ZitaConfigError` on fatal errors; "other" errors abort
    parsing but still return the partial spec with a warning attached.
    """
    if text is None:
        with open(path, "r", errors="replace") as f:
            text = f.read()
    spec = FilterSpec(path=path)
    cdir = os.path.dirname(os.path.abspath(path))

    def other(lnum: int, msg: str):
        spec.warn(f"{path}:{lnum}: {msg}")
        raise _AbortOther()

    try:
        for lnum, line in enumerate(text.splitlines(), 1):
            if not line.startswith("/"):
                stripped = line.lstrip()
                if stripped and stripped[0] > " " and stripped[0] != "#":
                    raise ZitaConfigError(path, lnum, "Syntax error.")
                continue
            # Split command word from arguments.
            m = re.match(r"(\S+)\s*", line)
            cmd = m.group(1)
            args = line[m.end() :]
            if cmd == "/cd":
                tok, consumed = sstring(args)
                if tok is None or consumed == 0:
                    raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
                cdir = tok if tok.startswith("/") else cdir + "/" + tok
            elif cmd == "/convolver/new":
                _convnew(spec, args, path, lnum, other)
            elif cmd == "/impulse/read":
                _read_op(spec, args, path, lnum, cdir, other)
            elif cmd == "/impulse/dirac":
                _dirac_op(spec, args, path, lnum)
            elif cmd == "/impulse/hilbert":
                _hilbert_op(spec, args, path, lnum)
            elif cmd == "/impulse/copy":
                _copy_op(spec, args, path, lnum)
            elif cmd in ("/input/name", "/output/name"):
                pass  # accepted, ignored (zita-fconfig.cc:100-109)
            else:
                raise ZitaConfigError(path, lnum, f"Unknown command '{cmd}'.")
    except _AbortOther:
        pass  # partial config is a success (zita-config.cc:345)
    return spec


def _require_conv(spec: FilterSpec, path: str, lnum: int, ip: int, op: int):
    """check_inout (zita-config.cc:46-52)."""
    conv = spec.convolver
    if conv is None or conv.size == 0:
        raise ZitaConfigError(path, lnum, "No convolver yet defined.")
    if not (1 <= ip <= conv.ninp) or not (1 <= op <= conv.nout):
        raise ZitaConfigError(path, lnum, "Bad input or output number.")


def _convnew(spec, args, path, lnum, other):
    from folve_tpu_torch.engine.constants import MAXINP, MAXOUT, MAXSIZE

    got = _scan(args, "uuuuf")
    if got is None:
        got = _scan(args, "uuuu")
        if got is None:
            raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
        (ninp, nout, _part, size), _ = got
        dens = 0.0
    else:
        (ninp, nout, _part, size, dens), _ = got
    if ninp == 0 or ninp > MAXINP:
        other(lnum, f"Number of inputs ({ninp}) is out of range.")
    if nout == 0 or nout > MAXOUT:
        other(lnum, f"Number of outputs ({nout}) is out of range.")
    if size > MAXSIZE:
        other(lnum, f"Convolver size ({size}) is out of range.")
    if dens < 0.0 or dens > MAX_DENSITY:
        other(lnum, "Density parameter is out of range.")
    spec.convolver = ConvolverDecl(ninp=ninp, nout=nout, size=size, density=dens)


def _read_op(spec, args, path, lnum, cdir, other):
    got = _scan(args, "uufuuuu")
    if got is None:
        raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
    (ip, op, gain, delay, offset, length, chan), pos = got
    tok, consumed = sstring(args[pos:])
    if tok is None or consumed == 0 or not tok:
        raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
    _require_conv(spec, path, lnum, ip, op)
    fpath = tok if tok.startswith("/") else cdir + "/" + tok
    spec.ops.append(
        ReadOp(
            inp=ip, out=op, gain=gain, delay=delay, offset=offset,
            length=length, channel=chan, path=fpath, line=lnum,
        )
    )


def _dirac_op(spec, args, path, lnum):
    got = _scan(args, "uufu")
    if got is None:
        raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
    (ip, op, gain, delay), _ = got
    _require_conv(spec, path, lnum, ip, op)
    spec.ops.append(DiracOp(inp=ip, out=op, gain=gain, delay=delay, line=lnum))


def _hilbert_op(spec, args, path, lnum):
    from folve_tpu_torch.engine.constants import MAX_HILBERT, MIN_HILBERT

    got = _scan(args, "uufuu")
    if got is None:
        raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
    (ip, op, gain, delay, length), _ = got
    _require_conv(spec, path, lnum, ip, op)
    if length < MIN_HILBERT or length > MAX_HILBERT:
        raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
    spec.ops.append(
        HilbertOp(inp=ip, out=op, gain=gain, delay=delay, length=length, line=lnum)
    )


def _copy_op(spec, args, path, lnum):
    got = _scan(args, "uuuu")
    if got is None:
        raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
    (ip1, op1, ip2, op2), _ = got
    _require_conv(spec, path, lnum, ip1, op1)
    _require_conv(spec, path, lnum, ip2, op2)
    if ip1 == ip2 and op1 == op2:
        raise ZitaConfigError(path, lnum, "Bad or missing parameters.")
    spec.ops.append(
        CopyOp(dst_inp=ip1, dst_out=op1, src_inp=ip2, src_out=op2, line=lnum)
    )
