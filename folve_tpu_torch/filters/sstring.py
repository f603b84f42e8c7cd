"""jconvolver-compatible quoted-string scanner.

Behavioral twin of the reference's ``sstring`` tokenizer
(zita-sstring.cc:32-116), used for filenames in filter configs:

* leading blanks skipped; tabs treated as spaces,
* single or double quotes delimit tokens that may contain spaces; a
  quote appearing mid-token (or mismatched) is an error,
* backslash escapes the next character, except inside single quotes
  where it is literal,
* a control character (including end-of-line) terminates an unquoted
  token but is an error inside quotes or after a dangling escape.
"""

from __future__ import annotations

from typing import Optional


def _is_control(ch: str) -> bool:
    o = ord(ch)
    return o < 0x20 or o == 0x7F


def sstring(src: str) -> tuple[Optional[str], int]:
    """Scan one token from ``src``.

    Returns ``(token, consumed)``; errors return ``(None, 0)``.  Note the
    reference signals errors with a zero return, which aliases the
    "empty input at position zero" case — callers there treat consumed==0
    as an error too, and ours do the same with ``token is None or not
    consumed``.
    """
    out: list[str] = []
    i = 0
    escape = False
    quote = ""
    n = len(src)
    while True:
        ch = src[i] if i < n else "\0"  # virtual terminator like C's NUL
        i += 1
        if ch == "\t":
            ch = " "
        if _is_control(ch):
            if quote or escape:
                return None, 0
            return "".join(out), i - 1
        if escape:
            out.append(ch)
            escape = False
            continue
        if ch == "\\":
            if quote == "'":
                out.append(ch)
            else:
                escape = True
            continue
        if ch in ("'", '"'):
            if ch == quote:
                return "".join(out), i
            if quote or out:
                return None, 0
            quote = ch
            continue
        if ch == " ":
            if quote:
                out.append(" ")
                continue
            if out:
                return "".join(out), i - 1
            continue
        out.append(ch)
